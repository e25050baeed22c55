"""Feed-forward blocks: gated SiLU (llama-style), GELU, squared-ReLU."""

from __future__ import annotations

import torch

from .common import Params, activation, dense_init


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str, *,
             lead=(), dtype=torch.float32) -> Params:
    p = {
        "w_up": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
        "w_down": dense_init(gen, d_ff, d_model, lead=lead, dtype=dtype),
    }
    if act == "silu":  # gated
        p["w_gate"] = dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype)
    return p


def mlp_apply(params: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """Weights are cast to the compute dtype at each product (a no-op when the
    caller passes weights already in that dtype)."""
    up = x @ params["w_up"].to(x.dtype)
    if act == "silu":
        h = activation("silu", x @ params["w_gate"].to(x.dtype)) * up
    else:
        h = activation(act, up)
    return h @ params["w_down"].to(x.dtype)
