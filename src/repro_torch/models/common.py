"""Shared model components: norms, activations, RoPE, sinusoidal
positions, initializers.

Functional style, as in the reference: every layer is an ``init`` that
returns a dict of tensors and an ``apply(params, x, ...)``.  Norms and RoPE
compute in float32 and cast back to the input dtype.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, object]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, lead=(),
               dtype=torch.float32) -> torch.Tensor:
    """``(*lead, d_in, d_out)`` normal matrix scaled by ``1/sqrt(d_in)``;
    ``lead`` is the stacked layer axis (and the expert axis).  Drawn in
    float32, scaled in place, then cast: a bf16 leaf is the bf16 cast of
    the float32 one, and the transient is one float32 copy."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.div_(math.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(kind: str, d: int, *, device, lead=(),
              dtype=torch.float32) -> Params:
    if kind == "rmsnorm":
        return {"scale": torch.ones((*lead, d), device=device, dtype=dtype)}
    if kind == "layernorm":
        return {"scale": torch.ones((*lead, d), device=device, dtype=dtype),
                "bias": torch.zeros((*lead, d), device=device, dtype=dtype)}
    if kind == "nonparam_ln":     # OLMo: LN without affine params
        return {}
    raise ValueError(kind)


def norm_apply(kind: str, params: Params, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    elif kind != "nonparam_ln":
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":               # jax.nn.gelu defaults to the tanh form
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":              # squared ReLU (Nemotron / RWKV channel-mix)
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Split halves (not interleaved pairs), computed in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, *, device="cpu") -> torch.Tensor:
    """(seq, d) float32: sin at the even channels, cos at the odd ones, the
    encoder's absolute positions (the reference's ``common.py:101-108``)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
