"""Serving, dense, ssm, moe, hybrid, audio and vlm families: one-pass
prefill and one-token decode steps.

``prefill`` runs the prompt through one full-sequence pass and fills the
decode state from it: for the attention families every layer's post-RoPE
K/V goes into the cache (the attention kernel on the card); for the ssm
family every layer leaves the chunked recurrence's final S (the recurrence
kernel on the card, once per layer) and the last position of its normed
time-mix and channel-mix inputs; for the hybrid family every Mamba2 block
leaves its final S (the recurrence kernel on the card, once per block) and
its conv's trailing context, and every application point of the shared
block its post-RoPE K/V (the attention kernel, once per point); the audio
family first runs the encoder once (``_encode_cross``: the attention
kernel once per encoder layer) and caches each decoder layer's cross K/V,
then every decoder layer's self-attention K/V goes into the cache and its
cross attention attends the prompt to the cached cross K/V (the kernel,
non-causal, Sq = the prompt, Skv = the cached frames).  The vlm family
is served as the dense family, on tokens alone: the reference's
``prefill`` and ``decode_step`` take no patch embeddings.  For the dense,
ssm, hybrid, audio and vlm families it returns the same last-position logits
and decode state as the reference's token-by-token
``repro.serve.decode.prefill``.  For the moe family the one
pass routes all B·S prompt tokens against one capacity, as the reference's
``forward`` does, where the reference's prefill routes B tokens a step:
the two agree when no (token, choice) pair is dropped (a high enough
``moe_capacity_factor``); at the default 1.25 the port's prefill equals the
reference's ``forward`` (ROADMAP.md, deliberate differences).
``decode_step`` moves one token on: attention layers attend it against the
cache with ``decode_attention`` (MoE layers then dispatch the B tokens with
``moe_apply_dense``), ssm and the hybrid's Mamba2 blocks step the
recurrence with ``linear_attention_step``, each application point of
the hybrid's shared block attends against its own cache, and each audio
decoder layer then attends the token to its cross K/V with
``decode_attention``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..models.attention import (decode_attention, out_project, q_project,
                                qkv_project)
from ..models.common import apply_rope, compute_dtype, norm_apply
from ..models.context import NULL_CTX, ModelContext, check_mesh
from ..models.mlp import mlp_apply
from ..models.moe import moe_apply_dense
from ..models.ssm import mamba2_apply, rwkv6_channel_mix, rwkv6_time_mix
from ..models.transformer import (attention_stacks, check_ported, cross_kv,
                                  encode, hidden_states, layer,
                                  logits_from_hidden, ssm_heads)
from .kv_cache import cache_names, cache_write, init_decode_state


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


def _rwkv6_decode(lp: Dict, x: torch.Tensor, cfg, state: Dict,
                  i: int) -> torch.Tensor:
    """x: (B,1,D); steps layer ``i``'s recurrence and token shifts, writing
    its S and last vectors into ``state`` in place."""
    h = norm_apply(cfg.norm, lp["ln1"], x)
    o, st = rwkv6_time_mix(lp["tmix"], h, cfg.rwkv_head_dim,
                           state={"S": state["rwkv_S"][i],
                                  "last": state["tmix_last"][i]})
    x = x + o
    h = norm_apply(cfg.norm, lp["ln2"], x)
    o, cmix_last = rwkv6_channel_mix(lp["cmix"], h,
                                     state=state["cmix_last"][i])
    state["rwkv_S"][i] = st["S"]
    state["tmix_last"][i] = st["last"]
    state["cmix_last"][i] = cmix_last
    return x + o


def _hybrid_decode(params: Dict, x: torch.Tensor, cfg, state: Dict,
                   pos: int) -> torch.Tensor:
    """x: (B,1,D); the reference's hybrid step (``decode.py:87-128``):
    each Mamba2 block steps its recurrence and conv context (written into
    ``state`` in place), each application point of the shared block
    writes its own cache slot."""
    x0, k, shared = x, cfg.attn_every, params["shared_block"]
    for g in range(cfg.num_layers // k):
        h = x
        for i in range(g * k, (g + 1) * k):
            lp = layer(params["layers"], i)
            o, st = mamba2_apply(lp["mamba"],
                                 norm_apply(cfg.norm, lp["ln"], h),
                                 ssm_heads(cfg), cfg.ssm_state,
                                 cfg.ssm_expand,
                                 state={"ssm": state["mamba_ssm"][i],
                                        "conv": state["mamba_conv"][i]})
            state["mamba_ssm"][i] = st["ssm"]
            state["mamba_conv"][i] = st["conv"]
            h = h + o
        z = torch.cat([h, x0], dim=-1) @ params["shared_proj"].to(h.dtype)
        zn = norm_apply(cfg.norm, shared["ln1"], z)
        z = z + _attn_decode(shared["attn"], zn, cfg, pos,
                             state["k_cache"][g], state["v_cache"][g])
        zn = norm_apply(cfg.norm, shared["ln2"], z)
        z = z + mlp_apply(shared["mlp"], zn, cfg.act)
        x = h + z
    return x


def _cross_decode(xl: Dict, x: torch.Tensor, cfg, state: Dict,
                  i: int) -> torch.Tensor:
    """x: (B,1,D); decoder layer ``i``'s cross attention (``decode.py:
    164-167``): norm, q without RoPE, the token against the cached cross K/V
    (``enc_len`` of them valid), out-project."""
    h = norm_apply(cfg.norm, xl["ln"], x)
    q = q_project(xl["attn"], h, cfg.num_heads, cfg.head_dim_)
    o = decode_attention(q, state["cross_k"][i], state["cross_v"][i],
                         state["enc_len"])
    return out_project(xl["attn"], o.to(x.dtype))


def decode_step(params: Dict, cfg, token: torch.Tensor, state: Dict, *,
                ctx: ModelContext = NULL_CTX) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1) int -> (logits (B, 1, V), new state).

    The tensors of ``state`` are updated in place and shared with the new
    state; ``cache_len`` advances by one."""
    check_ported(cfg)
    check_mesh(cfg, ctx, "decode")
    x = params["embed"][token].to(compute_dtype(cfg))
    x = ctx.shard(x, "dp", None, None)
    pos = state["cache_len"]
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _rwkv6_decode(layer(params["layers"], i), x, cfg, state, i)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, x, cfg, state, pos)
    else:
        for key, n, moe in attention_stacks(cfg):
            kc, vc = (state[name] for name in cache_names(key))
            for i in range(n):
                lp = layer(params[key], i)
                h = norm_apply(cfg.norm, lp["ln1"], x)
                x = x + _attn_decode(lp["attn"], h, cfg, pos, kc[i], vc[i])
                h = norm_apply(cfg.norm, lp["ln2"], x)
                x = x + (moe_apply_dense(lp["moe"], h, cfg)[0] if moe
                         else mlp_apply(lp["mlp"], h, cfg.act))
                if cfg.is_encoder_decoder:
                    x = x + _cross_decode(layer(params["cross_attn"], i), x,
                                          cfg, state, i)
    x = norm_apply(cfg.norm, params["ln_f"], x)
    return logits_from_hidden(params, cfg, x, ctx), {**state,
                                                     "cache_len": pos + 1}


def prefill(params: Dict, cfg, tokens: torch.Tensor, max_len: int, *,
            ctx: ModelContext = NULL_CTX,
            frame_embeds: Optional[torch.Tensor] = None,
            encoder_params: Optional[Dict] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) -> (last-position logits (B, 1, V), decode state).

    One ``hidden_states`` pass over the prompt.  Attention families: each
    layer's K/V goes into its cache (moe: the dense layers' into
    ``k/v_cache_dense``) through ``_fill_cache``.  Ssm: each layer's final
    S and last normed inputs go into the state.  Hybrid: each Mamba2
    block's final S and conv context, and each application point's K/V
    into its own cache.  MoE layers route the whole prompt against one
    capacity (see the module docstring).  Audio: ``_encode_cross`` on
    ``frame_embeds`` (B, S_enc, D) first, with ``encoder_params`` (default
    ``params``) for the encoder and the cross K/V projections; then the
    pass over the prompt, each decoder layer cross-attending to its cached
    cross K/V."""
    check_mesh(cfg, ctx, "prefill into a decode state")
    b, s = tokens.shape
    state = init_decode_state(cfg, b, max_len, dtype=compute_dtype(cfg),
                              device=tokens.device)
    cross = None
    if cfg.is_encoder_decoder:
        cross = _encode_cross(
            params if encoder_params is None else encoder_params, cfg,
            frame_embeds, state, ctx)
    sink: list = []
    x, _ = hidden_states(params, cfg, tokens, ctx=ctx, sink=sink,
                         cross=cross)
    if cfg.family == "ssm":
        for i, (S, tmix_last, cmix_last) in enumerate(sink):
            state["rwkv_S"][i] = S
            state["tmix_last"][i] = tmix_last
            state["cmix_last"][i] = cmix_last
    elif cfg.family == "hybrid":
        entries = iter(sink)
        for g in range(cfg.num_layers // cfg.attn_every):
            for i in range(g * cfg.attn_every, (g + 1) * cfg.attn_every):
                state["mamba_ssm"][i], state["mamba_conv"][i] = next(entries)
            _fill_cache(state["k_cache"][g], state["v_cache"][g],
                        *next(entries))
    else:
        kv = iter(sink)
        for key, n, _ in attention_stacks(cfg):
            kc, vc = (state[name] for name in cache_names(key))
            for i in range(n):
                _fill_cache(kc[i], vc[i], *next(kv))
    state["cache_len"] = s
    return logits_from_hidden(params, cfg, x[:, -1:], ctx), state


def _encode_cross(params: Dict, cfg, frame_embeds: Optional[torch.Tensor],
                  state: Dict, ctx: ModelContext
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The reference's ``_encode_cross`` (``decode.py:208-238``), writing
    ``state`` in place: (a) the encoder runs in the dtype of
    ``frame_embeds`` as given (not cast to the compute dtype, as
    ``forward`` does); (b) each layer's cross K/V goes into ``cross_k`` /
    ``cross_v`` in the state's dtype, the first ``max_len`` frames of it
    (the rest zero); (c) ``enc_len`` is S_enc, not clamped to ``max_len``.
    Returns each decoder layer's cached cross K/V cut to the
    min(S_enc, max_len) rows that decode attends to."""
    if frame_embeds is None:
        raise ValueError(f"{cfg.name}: the audio family needs frame_embeds "
                         f"(B, S_enc, d_model)")
    enc = encode(params, cfg, frame_embeds, ctx=ctx)
    n = min(enc.shape[1], state["cross_k"].shape[2])
    ck, cv = state["cross_k"], state["cross_v"]
    for i, (k, v) in enumerate(cross_kv(params, cfg, enc)):
        ck[i, :, :n] = k[:, :n]
        cv[i, :, :n] = v[:, :n]
    state["enc_len"] = enc.shape[1]
    return [(ck[i, :, :n], cv[i, :, :n]) for i in range(cfg.num_layers)]


def _fill_cache(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> None:
    """A prompt's K/V (B, S, Hkv, hd) into one layer's cache (B, cap, Hkv,
    hd), in the cache dtype, at slots pos % cap: for a rolling cache
    shorter than the prompt, only the last ``cap`` positions, the ones a
    token-by-token prefill leaves behind."""
    s, cap = k.shape[1], kc.shape[1]
    first = max(0, s - cap)
    slots = torch.arange(first, s, device=k.device) % cap
    kc[:, slots] = k[:, first:].to(kc.dtype)
    vc[:, slots] = v[:, first:].to(vc.dtype)
