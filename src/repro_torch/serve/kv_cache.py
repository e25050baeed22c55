"""Decode state: per-layer KV caches (dense, vlm, moe, audio), recurrent
states (ssm, hybrid), cross-attention caches (audio).

Layouts as the reference's:
  dense   k/v ``(L, B, cap, Hkv, hd)``, ``cap = min(max_len, window or inf)``;
          SWA caches are rolling, slot = pos % cap; the vlm family's too
  moe     the same for the MoE layers (leading axis L - moe_first_dense),
          and ``k_cache_dense`` / ``v_cache_dense`` for the leading dense
          layers (``moe_first_dense``), where there are any
  rwkv6   ``rwkv_S`` (L, B, H, K, V) float32; ``tmix_last`` / ``cmix_last``
          (L, B, D), the last normed time-mix / channel-mix inputs, in the
          compute dtype; O(1) in the context length
  hybrid  ``mamba_ssm`` (L, B, H, K, hd) float32 and ``mamba_conv``
          (L, B, 3, D_inner), the conv's trailing context, in the compute
          dtype, per Mamba2 block; ``k_cache`` / ``v_cache`` (L /
          attn_every, B, cap, Hkv, hd), one per application point of the
          shared block
  audio   the decoder's self-attention k/v as dense, and ``cross_k`` /
          ``cross_v`` ``(L, B, max_len, Hkv, hd)``, the encoder's output
          projected by each layer's cross attention (trimmed or zero-padded
          to ``max_len`` rows), in the same dtype; ``enc_len``, an int, the
          encoder's length, not clamped to ``max_len``
``cache_len`` is a Python int, the number of tokens already written.  Unlike
the reference's functional updates, the port writes the state in place.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import resolve_device
from ..models.transformer import attention_stacks, ssm_heads


def attn_cache_len(cfg, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_decode_state(cfg, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Zeroed decode state for one model."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        h, k = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        last = (cfg.num_layers, batch, cfg.d_model)
        return {"cache_len": 0,
                "rwkv_S": torch.zeros((cfg.num_layers, batch, h, k, k),
                                      dtype=torch.float32, device=dev),
                "tmix_last": torch.zeros(last, dtype=dtype, device=dev),
                "cmix_last": torch.zeros(last, dtype=dtype, device=dev)}
    if cfg.family == "hybrid":
        h, d_in = ssm_heads(cfg), cfg.d_model * cfg.ssm_expand
        kv = (cfg.num_layers // cfg.attn_every, batch,
              attn_cache_len(cfg, max_len), cfg.num_kv_heads, cfg.head_dim_)
        return {"cache_len": 0,
                "mamba_ssm": torch.zeros(
                    (cfg.num_layers, batch, h, cfg.ssm_state, d_in // h),
                    dtype=torch.float32, device=dev),
                "mamba_conv": torch.zeros((cfg.num_layers, batch, 3, d_in),
                                          dtype=dtype, device=dev),
                "k_cache": torch.zeros(kv, dtype=dtype, device=dev),
                "v_cache": torch.zeros(kv, dtype=dtype, device=dev)}
    state: Dict[str, Any] = {"cache_len": 0}
    for key, n, _ in attention_stacks(cfg):
        shape = (n, batch, attn_cache_len(cfg, max_len), cfg.num_kv_heads,
                 cfg.head_dim_)
        for name in cache_names(key):
            state[name] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.is_encoder_decoder:
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim_)
        state["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
        state["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
        state["enc_len"] = 0
    return state


def cache_names(stack: str) -> Tuple[str, str]:
    """The k and v cache keys of a stack of ``attention_stacks``."""
    suffix = "_dense" if stack == "dense_layers" else ""
    return f"k_cache{suffix}", f"v_cache{suffix}"


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> None:
    """Write one token (B, 1, Hkv, hd) at slot pos % cap, in place."""
    slot = pos % k_cache.shape[1]
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
