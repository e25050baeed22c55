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

Under a mesh (``ctx`` from ``parallel.sharding.make_context``) both entry
points take the params as ``bridge.place_params`` lays them out and the
tokens (and frames) as DTensors whose rows split over dp, or plain tensors,
the same on every rank, which they lay out so.  The decode state is built
in the reference's ``decode_state_specs`` layout (``kv_cache.
init_decode_state(view=)``) and filled from the one-pass prefill's sink;
the prefill runs the attention and recurrence kernels on each rank's local
heads.  A decode step writes each new K / V on the rank holding its slot,
and attends over the sequence-split cache with a distributed softmax
(``models.attention.decode_attention``); the recurrent states step on their
layouts; MoE layers run every rank's local experts on all B tokens
(``_moe_decode``).  The logits come back split over the vocab; ``greedy``
picks the next token from them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import is_dtensor
from ..models.attention import (decode_attention, out_project, q_project,
                                qkv_project)
from ..models.common import apply_rope, compute_dtype, norm_apply
from ..models.context import NULL_CTX, ModelContext
from ..models.mlp import mlp_apply
from ..models.moe import moe_apply_dense
from ..models.ssm import mamba2_apply, rwkv6_channel_mix, rwkv6_time_mix
from ..models.transformer import (_embed, _unflatten, attention_stacks,
                                  check_ported, cross_kv, encode,
                                  expert_layout, hidden_states, layer,
                                  logits_from_hidden, ssm_heads, vocab_split)
from ..parallel.sharding import shard_block
from ..train.tree import get_path
from .kv_cache import (cache_names, cache_write, fill_cache,
                       init_decode_state, layer_of, store, write_slots)


def _residual(ctx: ModelContext, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """x + y, both laid out as a decode step's activations (rows over dp,
    the rest whole); the identity layouts without a mesh."""
    return ctx.shard(x + ctx.shard(y, "dp", None, None), "dp", None, None)


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


def _rwkv6_decode(lp: Dict, x: torch.Tensor, cfg, state: Dict, i: int,
                  ctx: ModelContext) -> torch.Tensor:
    """x: (B,1,D); steps layer ``i``'s recurrence and token shifts, writing
    its S and last vectors into ``state`` in place."""
    h = ctx.shard(norm_apply(cfg.norm, lp["ln1"], x), "dp", None, None)
    o, st = rwkv6_time_mix(lp["tmix"], h, cfg.rwkv_head_dim,
                           state={"S": layer_of(state["rwkv_S"], i),
                                  "last": ctx.shard(layer_of(
                                      state["tmix_last"], i), "dp", None)})
    x = _residual(ctx, x, o)
    h = ctx.shard(norm_apply(cfg.norm, lp["ln2"], x), "dp", None, None)
    o, cmix_last = rwkv6_channel_mix(
        lp["cmix"], h, state=ctx.shard(layer_of(state["cmix_last"], i),
                                       "dp", None))
    store(state["rwkv_S"], i, st["S"])
    store(state["tmix_last"], i, st["last"])
    store(state["cmix_last"], i, cmix_last)
    return _residual(ctx, x, o)


def _hybrid_decode(params: Dict, x: torch.Tensor, cfg, state: Dict,
                   pos: int, ctx: ModelContext) -> torch.Tensor:
    """x: (B,1,D); the reference's hybrid step (``decode.py:87-128``):
    each Mamba2 block steps its recurrence and conv context (written into
    ``state`` in place), each application point of the shared block
    writes its own cache slot."""
    x0, k, shared = x, cfg.attn_every, params["shared_block"]
    for g in range(cfg.num_layers // k):
        h = x
        for i in range(g * k, (g + 1) * k):
            lp = layer(params["layers"], i)
            hn = ctx.shard(norm_apply(cfg.norm, lp["ln"], h), "dp", None,
                           None)
            o, st = mamba2_apply(lp["mamba"], hn, ssm_heads(cfg),
                                 cfg.ssm_state, cfg.ssm_expand,
                                 state={"ssm": layer_of(state["mamba_ssm"],
                                                        i),
                                        "conv": layer_of(state["mamba_conv"],
                                                         i)})
            store(state["mamba_ssm"], i, st["ssm"])
            store(state["mamba_conv"], i, st["conv"])
            h = _residual(ctx, h, o)
        z = torch.cat([h, x0], dim=-1) @ params["shared_proj"].to(h.dtype)
        z = ctx.shard(z, "dp", None, None)
        zn = norm_apply(cfg.norm, shared["ln1"], z)
        z = _residual(ctx, z, _attn_decode(
            shared["attn"], zn, cfg, pos, layer_of(state["k_cache"], g),
            layer_of(state["v_cache"], g)))
        zn = norm_apply(cfg.norm, shared["ln2"], z)
        z = _residual(ctx, z, mlp_apply(shared["mlp"], zn, cfg.act))
        x = _residual(ctx, h, z)
    return x


def _cross_decode(xl: Dict, x: torch.Tensor, cfg, state: Dict,
                  i: int) -> torch.Tensor:
    """x: (B,1,D); decoder layer ``i``'s cross attention (``decode.py:
    164-167``): norm, q without RoPE, the token against the cached cross K/V
    (``enc_len`` of them valid), out-project."""
    h = norm_apply(cfg.norm, xl["ln"], x)
    q = q_project(xl["attn"], h, cfg.num_heads, cfg.head_dim_)
    o = decode_attention(q, layer_of(state["cross_k"], i),
                         layer_of(state["cross_v"], i), state["enc_len"])
    return out_project(xl["attn"], o.to(x.dtype))


def _moe_decode(mp: Dict, h: torch.Tensor, cfg,
                ctx: ModelContext) -> torch.Tensor:
    """A decode step's MoE layer on its B tokens: ``moe_apply_dense``.
    Under a mesh every rank routes all B tokens (gathered, whole) against
    one capacity, as the single device does, runs its local experts (E
    over the EP axis, F over the expert-TP axis; ``expert_layout``) and
    the shared experts' slice of F, and the partial outputs add over the
    mesh dims that split them."""
    if ctx.mesh is None:
        return moe_apply_dense(mp, h, cfg)[0]
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx.dmesh
    layout = expert_layout(mp, ctx)
    names = list(layout)
    whole = [Replicate()] * mesh.ndim
    split = {a: mesh.get_group(a) for a in (ctx.ep_axis, ctx.ep_tp_axis)
             if a in mesh.mesh_dim_names}

    def local(*args):
        p = _unflatten(dict(zip(names, args[:-1])))
        shared, x = p.pop("shared", None), args[-1]
        n = p["w_up"].shape[0]
        first = (shard_block(mesh, [mesh.mesh_dim_names.index(ctx.ep_axis)])
                 * n if ctx.ep_axis in split else 0)
        y = moe_apply_dense(p, x, cfg, experts=(first, n))[0]
        for g in split.values():
            dist.all_reduce(y, group=g)
        if shared is not None:
            ys = mlp_apply(shared, x, "silu")
            if ctx.ep_tp_axis in split:
                dist.all_reduce(ys, group=split[ctx.ep_tp_axis])
            y = y + ys
        return y

    return local_map(local, out_placements=whole,
                     in_placements=(*layout.values(), whole),
                     device_mesh=mesh)(
        *(get_path(mp, n).redistribute(mesh, pl)
          for n, pl in layout.items()), h.redistribute(mesh, whole))


def _rows(x: Optional[torch.Tensor], ctx: ModelContext):
    """Under a mesh, a plain batch tensor (the same on every rank) laid out
    by rows over dp; a DTensor or no mesh: as it is."""
    if x is None or ctx.mesh is None or is_dtensor(x):
        return x
    from ..parallel.sharding import distribute_local
    return distribute_local(x, ctx.dmesh, ctx.placements(
        "dp", *[None] * (x.dim() - 1)))


def greedy(logits: torch.Tensor, ctx: ModelContext = NULL_CTX
           ) -> torch.Tensor:
    """The greedy next token (B, 1) of logits (B, 1, V): the first index of
    the largest logit, as ``argmax`` picks it.  Under a mesh the logits'
    vocab stays split (as far as V divides, ``sanitize_spec``): each rank
    takes its block's largest logit and first index, the largest value is
    reduced over the vocab's mesh dims and then the least index holding
    it; the token is laid out by rows as the logits are."""
    if ctx.mesh is None:
        return logits.argmax(dim=-1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ctx.dmesh
    pl, dims = vocab_split(logits, ctx)
    lg = logits.redistribute(mesh, pl).to_local()
    idx = lg.argmax(dim=-1)
    best = lg.gather(-1, idx[..., None])[..., 0].float()
    top = best.clone()
    for i in dims:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    idx = idx + shard_block(mesh, dims) * lg.shape[-1]
    tok = torch.where(best == top, idx, torch.iinfo(idx.dtype).max)
    for i in dims:
        dist.all_reduce(tok, op=dist.ReduceOp.MIN, group=mesh.get_group(i))
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    return DTensor.from_local(tok, mesh, rows, run_check=False,
                              shape=logits.shape[:2],
                              stride=(logits.shape[1], 1))


def decode_step(params: Dict, cfg, token: torch.Tensor, state: Dict, *,
                ctx: ModelContext = NULL_CTX) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1) int -> (logits (B, 1, V), new state).

    The tensors of ``state`` are updated in place and shared with the new
    state; ``cache_len`` advances by one."""
    check_ported(cfg)
    with ctx.scope():
        x = _embed(params["embed"], _rows(token, ctx), ctx).to(
            compute_dtype(cfg))
        x = ctx.shard(x, "dp", None, None)
        pos = state["cache_len"]
        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                x = _rwkv6_decode(layer(params["layers"], i), x, cfg, state,
                                  i, ctx)
        elif cfg.family == "hybrid":
            x = _hybrid_decode(params, x, cfg, state, pos, ctx)
        else:
            for key, n, moe in attention_stacks(cfg):
                kc, vc = (state[name] for name in cache_names(key))
                for i in range(n):
                    lp = layer(params[key], i)
                    h = norm_apply(cfg.norm, lp["ln1"], x)
                    x = _residual(ctx, x, _attn_decode(
                        lp["attn"], h, cfg, pos, layer_of(kc, i),
                        layer_of(vc, i)))
                    h = norm_apply(cfg.norm, lp["ln2"], x)
                    x = _residual(ctx, x, _moe_decode(lp["moe"], h, cfg, ctx)
                                  if moe else mlp_apply(lp["mlp"], h,
                                                        cfg.act))
                    if cfg.is_encoder_decoder:
                        x = _residual(ctx, x, _cross_decode(
                            layer(params["cross_attn"], i), x, cfg, state,
                            i))
        x = norm_apply(cfg.norm, params["ln_f"], x)
        return logits_from_hidden(params, cfg, x, ctx), {
            **state, "cache_len": pos + 1}


def prefill(params: Dict, cfg, tokens: torch.Tensor, max_len: int, *,
            ctx: ModelContext = NULL_CTX,
            frame_embeds: Optional[torch.Tensor] = None,
            encoder_params: Optional[Dict] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) -> (last-position logits (B, 1, V), decode state).

    One ``hidden_states`` pass over the prompt.  Attention families: each
    layer's K/V goes into its cache (moe: the dense layers' into
    ``k/v_cache_dense``) through ``fill_cache``.  Ssm: each layer's final
    S and last normed inputs go into the state.  Hybrid: each Mamba2
    block's final S and conv context, and each application point's K/V
    into its own cache.  MoE layers route the whole prompt against one
    capacity (see the module docstring).  Audio: ``_encode_cross`` on
    ``frame_embeds`` (B, S_enc, D) first, with ``encoder_params`` (default
    ``params``) for the encoder and the cross K/V projections; then the
    pass over the prompt, each decoder layer cross-attending to its cached
    cross K/V.  Under a mesh the state is laid out as ``launch.dryrun.
    decode_state_specs`` lays it out."""
    check_ported(cfg)
    b, s = tokens.shape
    with ctx.scope():
        tokens = _rows(tokens, ctx)
        state = init_decode_state(cfg, b, max_len, dtype=compute_dtype(cfg),
                                  device=tokens.device, view=ctx.mesh)
        cross = None
        if cfg.is_encoder_decoder:
            cross = _encode_cross(
                params if encoder_params is None else encoder_params, cfg,
                _rows(frame_embeds, ctx), state, ctx)
        sink: list = []
        x, _ = hidden_states(params, cfg, tokens, ctx=ctx, sink=sink,
                             cross=cross)
        if cfg.family == "ssm":
            for i, entry in enumerate(sink):
                for name, t in zip(("rwkv_S", "tmix_last", "cmix_last"),
                                   entry):
                    store(state[name], i, t)
        elif cfg.family == "hybrid":
            entries = iter(sink)
            for g in range(cfg.num_layers // cfg.attn_every):
                for i in range(g * cfg.attn_every,
                               (g + 1) * cfg.attn_every):
                    S, conv = next(entries)
                    store(state["mamba_ssm"], i, S)
                    store(state["mamba_conv"], i, conv)
                fill_cache(layer_of(state["k_cache"], g),
                           layer_of(state["v_cache"], g), *next(entries))
        else:
            kv = iter(sink)
            for key, n, _ in attention_stacks(cfg):
                kc, vc = (state[name] for name in cache_names(key))
                for i in range(n):
                    fill_cache(layer_of(kc, i), layer_of(vc, i), *next(kv))
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
    Returns each decoder layer's cross K/V as cached (in the state's dtype),
    cut to the min(S_enc, max_len) rows that decode attends to."""
    if frame_embeds is None:
        raise ValueError(f"{cfg.name}: the audio family needs frame_embeds "
                         f"(B, S_enc, d_model)")
    enc = encode(params, cfg, frame_embeds, ctx=ctx)
    n = min(enc.shape[1], state["cross_k"].shape[2])
    out = []
    for i, (k, v) in enumerate(cross_kv(params, cfg, enc)):
        kv = (k[:, :n].to(state["cross_k"].dtype),
              v[:, :n].to(state["cross_v"].dtype))
        for name, t in zip(("cross_k", "cross_v"), kv):
            write_slots(layer_of(state[name], i), t, 0)
        out.append(kv)
    state["enc_len"] = enc.shape[1]
    return out
