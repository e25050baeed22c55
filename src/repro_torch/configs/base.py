"""Architecture configuration dataclass and the config registry.

The port keeps its own copy of the reference's ``ModelConfig``,
``ShapeConfig`` / ``SHAPES`` and ``RunConfig`` so that it imports nothing of
the JAX package; ``tests/test_torch_model.py`` holds the two copies against
each other field by field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Field defaults cover the dense-LM case; MoE / SSM /
    hybrid / enc-dec / frontend extensions are opt-in."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    act: str = "silu"                # silu (gated) | gelu | relu2
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparam_ln
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None
    max_seq_len: int = 524288

    # -- MoE ----------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: Optional[int] = None   # per-expert FFN width (fine-grained MoE)
    moe_first_dense: int = 0         # leading dense layers (deepseek layer 0)
    moe_capacity_factor: float = 1.25

    # -- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0               # Mamba2 d_state
    ssm_heads: int = 0               # Mamba2 heads (default num_heads)
    ssm_expand: int = 2
    attn_every: int = 0              # hybrid: shared attn block every k blocks
    rwkv_head_dim: int = 64

    # -- encoder-decoder -------------------------------------------------------
    encoder_layers: int = 0
    is_encoder_decoder: bool = False

    # -- stub modality frontends ------------------------------------------------
    frontend: Optional[str] = None   # "patch" (vlm) | "frames" (audio)
    num_patches: int = 256           # patch embeddings prepended (vlm)

    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM state, hybrid, SWA)"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline bookkeeping)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.act == "silu":          # gated: up, gate, down
            mlp = 3 * d * f
        else:                            # up, down
            mlp = 2 * d * f
        per_layer = attn + mlp + 2 * d
        total = 0
        if self.family == "moe":
            ef = self.moe_d_ff or f
            moe_mlp = 3 * d * ef * (self.moe_num_experts + self.moe_shared_experts)
            router = d * self.moe_num_experts
            dense_layers = self.moe_first_dense
            moe_layers = self.num_layers - dense_layers
            total += dense_layers * per_layer
            total += moe_layers * (attn + moe_mlp + router + 2 * d)
        elif self.family == "ssm":       # rwkv6: time-mix ≈ 6 d², channel-mix
            per = 6 * d * d + 2 * d * f + 4 * d
            total += self.num_layers * per
        elif self.family == "hybrid":    # mamba2 blocks + one shared attn block
            din = d * self.ssm_expand
            mamba = 2 * d * din + din * d + din * (2 * self.ssm_state) + 3 * d
            total += self.num_layers * mamba
            total += attn + mlp + 2 * d  # shared block counted once
        else:
            total += self.num_layers * per_layer
        if self.is_encoder_decoder:
            # encoder layers + cross-attention in decoder layers
            total += self.encoder_layers * (attn + mlp + 2 * d)
            total += self.num_layers * attn
        total += v * d * (1 if self.tie_embeddings else 2)
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                        # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    """Training/serving execution knobs (parallelism, memory policy)."""

    microbatch: int = 0              # 0 = no gradient accumulation
    remat: str = "full"              # full | none | dots
    sequence_parallel: bool = True
    zero_sharded_opt: bool = True    # shard optimizer state over dp axis
    grad_compression: bool = False   # int8 + error feedback
    ssm_chunk: int = 128             # linear-attention chunk
    pipeline_stages: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    logical_axis_overrides: Tuple[Tuple[str, str], ...] = ()


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; the port has {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (tests run this on CPU)."""
    small = dict(
        num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 4,
        d_ff=128, vocab_size=256, head_dim=16, max_seq_len=512,
    )
    if cfg.family == "moe":
        small.update(moe_num_experts=min(cfg.moe_num_experts, 4),
                     moe_top_k=min(cfg.moe_top_k, 2),
                     moe_shared_experts=min(cfg.moe_shared_experts, 1),
                     moe_d_ff=64, moe_first_dense=min(cfg.moe_first_dense, 1))
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=min(cfg.ssm_state or 16, 16), ssm_heads=4,
                     rwkv_head_dim=16)
    if cfg.attn_every:
        small.update(attn_every=2)
    if cfg.is_encoder_decoder:
        small.update(encoder_layers=2)
    if cfg.sliding_window:
        small.update(sliding_window=128)
    if cfg.frontend:
        small.update(num_patches=16)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
