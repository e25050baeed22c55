"""Serving, dense family: one-pass prefill and one-token decode steps.

``prefill`` runs the prompt through one full-sequence pass (the attention
kernel on the card) and writes every layer's post-RoPE K/V into the cache.
It returns the same last-position logits and decode state as the
reference's token-by-token ``repro.serve.decode.prefill``.  ``decode_step``
attends one new token against the cache with ``decode_attention``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.attention import decode_attention, out_project, qkv_project
from ..models.common import apply_rope, compute_dtype, norm_apply
from ..models.context import NULL_CTX, ModelContext
from ..models.mlp import mlp_apply
from ..models.transformer import (check_ported, hidden_states, layer,
                                  logits_from_hidden)
from .kv_cache import cache_write, init_decode_state


def _attn_decode(layer_attn: Dict, x: torch.Tensor, cfg, pos: int,
                 kc: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """x: (B,1,D); writes this token's K/V into kc/vc (B, cap, Hkv, hd)."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q, k, v = qkv_project(layer_attn, x, hq, hkv, hd)
    positions = torch.full((1, 1), pos, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache_write(kc, vc, k.to(kc.dtype), v.to(vc.dtype), pos)
    o = decode_attention(q, kc, vc, min(pos + 1, kc.shape[1]))
    return out_project(layer_attn, o.to(x.dtype))


def decode_step(params: Dict, cfg, token: torch.Tensor, state: Dict, *,
                ctx: ModelContext = NULL_CTX) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1) int -> (logits (B, 1, V), new state).

    The caches of ``state`` are updated in place and shared with the new
    state; ``cache_len`` advances by one."""
    check_ported(cfg)
    x = params["embed"][token].to(compute_dtype(cfg))
    x = ctx.shard(x, "dp", None, None)
    pos = state["cache_len"]
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h = norm_apply(cfg.norm, lp["ln1"], x)
        x = x + _attn_decode(lp["attn"], h, cfg, pos, state["k_cache"][i],
                             state["v_cache"][i])
        h = norm_apply(cfg.norm, lp["ln2"], x)
        x = x + mlp_apply(lp["mlp"], h, cfg.act)
    x = norm_apply(cfg.norm, params["ln_f"], x)
    return logits_from_hidden(params, cfg, x, ctx), {**state,
                                                     "cache_len": pos + 1}


def prefill(params: Dict, cfg, tokens: torch.Tensor, max_len: int, *,
            ctx: ModelContext = NULL_CTX) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) -> (last-position logits (B, 1, V), decode state).

    One ``hidden_states`` pass over the prompt; each layer's K/V goes into
    the cache, in the cache dtype, at slots pos % cap (for a rolling cache
    shorter than the prompt, only the last ``cap`` positions, which are the
    ones a token-by-token prefill leaves behind)."""
    b, s = tokens.shape
    state = init_decode_state(cfg, b, max_len, dtype=compute_dtype(cfg),
                              device=tokens.device)
    kv: list = []
    x = hidden_states(params, cfg, tokens, ctx=ctx, kv_sink=kv)
    cap = state["k_cache"].shape[2]
    first = max(0, s - cap)
    slots = torch.arange(first, s, device=tokens.device) % cap
    for i, (k, v) in enumerate(kv):
        state["k_cache"][i][:, slots] = k[:, first:].to(state["k_cache"].dtype)
        state["v_cache"][i][:, slots] = v[:, first:].to(state["v_cache"].dtype)
    state["cache_len"] = s
    return logits_from_hidden(params, cfg, x[:, -1:], ctx), state
