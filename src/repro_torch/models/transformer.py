"""LM assembly: the dense, ssm (RWKV6), moe, hybrid (zamba2), audio
(whisper) and vlm (phi-3-vision) families.

Same parameter layout as the reference (``repro/models/transformer.py``):
nested dicts with a stacked leading ``L`` axis on every layer leaf and
``(d_in, d_out)`` matrices, so ``bridge.params_from_numpy`` hands the
reference's own params to these functions.  The reference's ``lax.scan``
over ``L`` is a Python loop over the stacked axis here.

The dense family (slice 1 of the port) and the ssm family (slice 3) are
ported, for serving and, since slice 4, for training (``lm_loss`` on the
float32 master tree); the moe family (slice 5a) through the single-device
dispatch ``moe_apply_dense``, its ``moe_first_dense`` leading layers in
``dense_layers`` as in the reference; the hybrid family (slice 5b):
stacked Mamba2 ``layers`` and one ``shared_block`` (an attention + MLP
block, unstacked) applied after every ``attn_every`` of them on
``concat(h, x0) @ shared_proj``; the audio family (slice 5c), an
encoder-decoder: a non-causal encoder over frame embeddings (the stub
frontend) with sinusoidal positions, then decoder layers that each add a
cross attention to the encoder's output after their MLP; the vlm family
(slice 5d), the dense stack on a sequence whose first P token embeddings
are replaced by patch embeddings projected by ``patch_proj``
(``merge_patches``, the stub frontend).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .attention import attention_block, attn_init, kv_project
from .common import (Params, compute_dtype, dense_init, embed_init,
                     norm_apply, norm_init, sinusoidal_positions)
from ..parallel.sharding import axis_sizes, shard_block
from ..train.tree import get_path
from .context import NULL_CTX, ModelContext
from .mlp import mlp_apply, mlp_init
from .moe import _SumOver, moe_apply_a2a, moe_apply_dense, moe_init
from .ssm import (mamba2_apply, mamba2_init, rwkv6_channel_mix,
                  rwkv6_channel_mix_init, rwkv6_init, rwkv6_time_mix)


# each family's stub frontend; only the audio family is an encoder-decoder
FRONTENDS = {"dense": None, "ssm": None, "moe": None, "hybrid": None,
             "audio": "frames", "vlm": "patch"}


def check_ported(cfg) -> None:
    if (cfg.family not in FRONTENDS
            or cfg.is_encoder_decoder != (cfg.family == "audio")
            or cfg.frontend != FRONTENDS[cfg.family]):
        raise NotImplementedError(
            f"{cfg.name}: family '{cfg.family}' (encoder-decoder "
            f"{cfg.is_encoder_decoder}, frontend {cfg.frontend}) is not a "
            f"model the port builds; it runs the dense family (slice 1), the "
            f"ssm family (slice 3), the moe family (slice 5a) and the hybrid "
            f"family (slice 5b) as decoders without a frontend, the audio "
            f"family (slice 5c) as an encoder-decoder on frame embeddings and "
            f"the vlm family (slice 5d) as a decoder on patch embeddings")
    if cfg.family == "hybrid" and (cfg.attn_every < 1
                                   or cfg.num_layers % cfg.attn_every):
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} must be "
                         f"a multiple of attn_every {cfg.attn_every}")


def ssm_heads(cfg) -> int:
    """Mamba2 heads of the hybrid family (``num_heads`` when unset)."""
    return cfg.ssm_heads or cfg.num_heads


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg, lead: tuple, *, moe: bool, dtype,
                dev) -> Params:
    """Attention blocks with an MLP, or with an MoE layer, stacked on the
    ``lead`` axes (``()``: one block, unstacked)."""
    d = cfg.d_model
    p: Params = {
        "ln1": norm_init(cfg.norm, d, lead=lead, device=dev),
        "ln2": norm_init(cfg.norm, d, lead=lead, device=dev),
        "attn": attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim_, cfg.qkv_bias, lead=lead,
                          dtype=dtype),
    }
    if moe:
        p["moe"] = moe_init(gen, d, cfg.moe_num_experts,
                            cfg.moe_d_ff or cfg.d_ff, cfg.moe_shared_experts,
                            lead=lead, dtype=dtype)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.act, lead=lead,
                            dtype=dtype)
    return p


class _Generator(torch.Generator):
    """``init_lm``'s generator: may carry a ``place`` hook (``common.
    drawn``)."""

    place = None


class _MetaGenerator(_Generator):
    """A generator whose draws land on the ``meta`` device: shapes and
    dtypes only (``parallel.sharding.abstract_params``)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_lm(cfg, seed: int = 0, *, device="cuda",
            dtype=torch.float32, place=None) -> Params:
    """Random parameters from ``seed`` (a ``torch.Generator`` on ``device``);
    the reference's layout and initializer scales, not its random numbers.
    ``dtype`` is the matrices' (norms and the MoE router stay float32); each
    is drawn in float32 and cast, so a bf16 tree is the bf16 cast of the
    float32 tree from the same seed.  ``device="meta"`` gives the tree's
    shapes and dtypes without allocating.  ``place``, when given, takes
    each random matrix as soon as it is drawn, in draw order, and returns
    what the tree keeps in its place (``bridge.init_sharded``: the rank's
    shard)."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = (_MetaGenerator() if dev.type == "meta"
           else _Generator(device=dev).manual_seed(seed))
    gen.place = place
    d, L = cfg.d_model, (cfg.num_layers,)
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, d, dtype),
                 "ln_f": norm_init(cfg.norm, d, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dtype=dtype)
    if cfg.family == "ssm":  # rwkv6
        p["layers"] = {
            "ln1": norm_init(cfg.norm, d, lead=L, device=dev),
            "ln2": norm_init(cfg.norm, d, lead=L, device=dev),
            "tmix": rwkv6_init(gen, d, cfg.rwkv_head_dim, lead=L,
                               dtype=dtype),
            "cmix": rwkv6_channel_mix_init(gen, d, cfg.d_ff, lead=L,
                                           dtype=dtype)}
        return p
    if cfg.family == "hybrid":  # zamba2
        p["layers"] = {
            "ln": norm_init(cfg.norm, d, lead=L, device=dev),
            "mamba": mamba2_init(gen, d, cfg.ssm_state, ssm_heads(cfg),
                                 cfg.ssm_expand, lead=L, dtype=dtype)}
        p["shared_block"] = _block_init(gen, cfg, (), moe=False, dtype=dtype,
                                        dev=dev)
        p["shared_proj"] = dense_init(gen, 2 * d, d, dtype=dtype)
        return p
    for key, n, moe in attention_stacks(cfg):
        p[key] = _block_init(gen, cfg, (n,), moe=moe, dtype=dtype, dev=dev)
    if cfg.is_encoder_decoder:  # whisper (transformer.py:116-130)
        p["encoder_layers"] = _block_init(gen, cfg, (cfg.encoder_layers,),
                                          moe=False, dtype=dtype, dev=dev)
        p["cross_attn"] = {
            "ln": norm_init(cfg.norm, d, lead=L, device=dev),
            "attn": attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim_, cfg.qkv_bias, lead=L,
                              dtype=dtype)}
        p["ln_enc"] = norm_init(cfg.norm, d, device=dev)
    if cfg.frontend == "patch":  # phi-3-vision (transformer.py:131-132)
        p["patch_proj"] = dense_init(gen, d, d, dtype=dtype)
    return p


def attention_stacks(cfg) -> List[Tuple[str, int, bool]]:
    """The stacked layers of an attention LM in order, as (params key,
    number of layers, MoE?): the dense, vlm and audio families' ``layers``;
    the moe family's ``dense_layers`` (its ``moe_first_dense`` leading
    dense layers, where it has any), then its MoE ``layers``."""
    if cfg.family != "moe":
        return [("layers", cfg.num_layers, False)]
    n = cfg.moe_first_dense
    return ([("dense_layers", n, False)] if n else []) + [
        ("layers", cfg.num_layers - n, True)]


def layer(params: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


def unstack(params: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree as views, each leaf cut by one
    ``unbind``: its backward stacks the layers' grads once, where ``n``
    separate ``layer`` views would each add a full-size zero-padded grad."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in params.items():
        parts = unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for tree, part in zip(out, parts):
            tree[k] = part
    return out


def _lm_head(params: Params, cfg) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _fit_chunk(t: int, chunk: int) -> int:
    """Largest power-of-two-ish chunk <= `chunk` dividing sequence length."""
    c = min(chunk, t)
    while t % c:
        c //= 2
    return max(c, 1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attention_half(lp: Params, x: torch.Tensor, cfg, ctx: ModelContext,
                    positions: Optional[torch.Tensor], kv_sink,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual after attention, and its norm (the FFN's input)."""
    h = norm_apply(cfg.norm, lp["ln1"], x)
    h = ctx.shard(h, "dp", None, None)
    # each sub-block's output is laid out as the residual before the add
    # (Megatron-SP's reduce-scatter point), so its grad comes back whole
    a = attention_block(lp["attn"], h, cfg, positions, kv_sink,
                        causal=causal)
    x = x + ctx.shard(a, "dp", "sp", None)
    x = ctx.shard(x, "dp", "sp", None)
    h = norm_apply(cfg.norm, lp["ln2"], x)
    return x, ctx.shard(h, "dp", None, None)


def _dense_block(lp: Params, x: torch.Tensor, cfg, ctx: ModelContext,
                 positions: Optional[torch.Tensor], kv_sink=None,
                 causal: bool = True) -> torch.Tensor:
    x, h = _attention_half(lp, x, cfg, ctx, positions, kv_sink, causal)
    y = ctx.shard(mlp_apply(lp["mlp"], h, cfg.act), "dp", "sp", None)
    return ctx.shard(x + y, "dp", "sp", None)


def _decoder_block(lp: Params, xl: Params, x: torch.Tensor, cfg,
                   ctx: ModelContext, positions: torch.Tensor,
                   cross: Tuple[torch.Tensor, torch.Tensor],
                   kv_sink=None) -> torch.Tensor:
    """An enc-dec decoder layer (``transformer.py:312-322``): the dense
    block, then ``cross_attn``'s norm and cross attention to ``cross``, the
    encoder's k / v of this layer; laid out as ``_attention_half`` lays out
    the self attention."""
    x = _dense_block(lp, x, cfg, ctx, positions, kv_sink)
    h = ctx.shard(norm_apply(cfg.norm, xl["ln"], x), "dp", None, None)
    a = attention_block(xl["attn"], h, cfg, kv_override=cross)
    return ctx.shard(x + ctx.shard(a, "dp", "sp", None), "dp", "sp", None)


def _moe_block(lp: Params, x: torch.Tensor, cfg, ctx: ModelContext,
               positions: torch.Tensor, kv_sink=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_block``: returns (x, this layer's aux).  Under
    a mesh with an EP axis that divides the sequence, expert parallelism
    with a sequence-sharded dispatch (``_moe_a2a``); otherwise
    ``moe_apply_dense``."""
    x, h = _attention_half(lp, x, cfg, ctx, positions, kv_sink)
    if (ctx.mesh is not None and ctx.ep_axis is not None
            and h.shape[1] % axis_sizes(ctx.mesh)[ctx.ep_axis] == 0):
        y, aux = _moe_a2a(lp["moe"], h, cfg, ctx)
    else:
        y, aux = moe_apply_dense(lp["moe"], h, cfg)
    return ctx.shard(x + ctx.shard(y, "dp", "sp", None), "dp", "sp",
                     None), aux


def _moe_a2a(mp: Params, h: torch.Tensor, cfg, ctx: ModelContext
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with a SEQUENCE-sharded dispatch (the reference's
    ``transformer.py:178-206``): each EP peer routes its own 1/ep slice of
    the tokens, so the AlltoAll moves only real work.  ``moe_apply_a2a``
    runs per rank inside ``local_map``: tokens (dp, ep, None), experts E
    over the EP axis and F over the expert-TP axis, the router and the
    shared experts' other dims whole.  A weight whole on a mesh dim that
    splits the tokens gets a partial grad there, and the aux loss is the
    mean over those dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..parallel.sharding import P, spec_placements
    ep, tp, mesh = ctx.ep_axis, ctx.ep_tp_axis, ctx.mesh
    dmesh = ctx.dmesh
    layout = expert_layout(mp, ctx)
    names, ins = list(layout), list(layout.values())
    x_pl = spec_placements(P(ctx.axes.get("dp"), ep, None), mesh)
    grads = [[Partial() if isinstance(p, Replicate) and isinstance(xp, Shard)
              else p for p, xp in zip(pl, x_pl)] for pl in ins]
    leaves = [get_path(mp, n).redistribute(dmesh, pl)
              for n, pl in zip(names, ins)]

    splits = [a for a, p in zip(dmesh.mesh_dim_names, x_pl)
              if isinstance(p, Shard)]

    def local(*args):
        return moe_apply_a2a(_unflatten(dict(zip(names, args))), args[-1],
                             cfg, mesh=dmesh, ep_axis=ep, tp_axis=tp,
                             mean_axes=splits)

    fn = local_map(local, out_placements=(x_pl, [Replicate()] * dmesh.ndim),
                   in_placements=(*ins, x_pl),
                   in_grad_placements=(*grads, x_pl), device_mesh=dmesh)
    return fn(*leaves, h.redistribute(dmesh, x_pl))


def expert_layout(mp: Params, ctx: ModelContext) -> Dict[str, list]:
    """The placements, by path, in which each rank reads the MoE layer
    ``mp`` (``_moe_a2a``, and a decode step's ``serve.decode._moe_decode``):
    experts E over the EP axis and F over the expert-TP axis, the router
    and the shared experts' other dims whole."""
    from ..parallel.sharding import P, spec_placements
    ep, tp = ctx.ep_axis, ctx.ep_tp_axis
    specs = {"router": P(None, None), "w_up": P(ep, None, tp),
             "w_gate": P(ep, None, tp), "w_down": P(ep, tp, None)}
    if "shared" in mp:
        specs.update({"shared/w_up": P(None, tp), "shared/w_gate":
                      P(None, tp), "shared/w_down": P(tp, None)})
    return {n: spec_placements(s, ctx.mesh) for n, s in specs.items()}


def _rwkv6_block(lp: Params, x: torch.Tensor, cfg, ctx: ModelContext,
                 chunk: int, sink=None) -> torch.Tensor:
    """The reference's ssm layer (``transformer.py:241-251``).  Under a mesh
    each mixer's input is laid out with the whole sequence, since the token
    shift reads the previous position (as attention's input is, in
    ``_attention_half``), and each mixer's output takes the residual's
    layout before the add."""
    h = ctx.shard(norm_apply(cfg.norm, lp["ln1"], x), "dp", None, None)
    y, st = rwkv6_time_mix(lp["tmix"], h, cfg.rwkv_head_dim, chunk=chunk)
    x = ctx.shard(x + ctx.shard(y, "dp", "sp", None), "dp", "sp", None)
    h = ctx.shard(norm_apply(cfg.norm, lp["ln2"], x), "dp", None, None)
    y, cmix_last = rwkv6_channel_mix(lp["cmix"], h)
    if sink is not None:
        sink.append((st["S"], st["last"], cmix_last))
    return ctx.shard(x + ctx.shard(y, "dp", "sp", None), "dp", "sp", None)


def _mamba2_block(lp: Params, x: torch.Tensor, cfg, ctx: ModelContext,
                  chunk: int, sink=None) -> torch.Tensor:
    """A Mamba2 layer; under a mesh its input has the whole sequence (the
    causal conv reads the three positions before each) and its output takes
    the residual's layout before the add."""
    h = ctx.shard(norm_apply(cfg.norm, lp["ln"], x), "dp", None, None)
    y, st = mamba2_apply(lp["mamba"], h, ssm_heads(cfg), cfg.ssm_state,
                         cfg.ssm_expand, chunk=chunk)
    if sink is not None:
        sink.append((st["ssm"], st["conv"]))
    return ctx.shard(x + ctx.shard(y, "dp", "sp", None), "dp", "sp", None)


def _hybrid_stack(params: Params, x: torch.Tensor, cfg, ctx: ModelContext,
                  positions: torch.Tensor, chunk: int, sink=None
                  ) -> torch.Tensor:
    """The reference's hybrid groups (``transformer.py:256-282``): per
    group, ``attn_every`` Mamba2 blocks (each under ``ctx.maybe_remat``),
    then the shared block on ``concat(h, x0) @ shared_proj`` added to h.
    x0 is the embedded input ``x``.  Under a mesh the concatenation is laid
    out with the whole sequence before the column-parallel ``shared_proj``
    (as attention's input is), and the projection's TP-split columns take
    the residual's layout before the shared block."""
    x0, k = x, cfg.attn_every
    block = ctx.maybe_remat(_mamba2_block)
    layers = unstack(params["layers"], cfg.num_layers)
    for g in range(cfg.num_layers // k):
        h = x
        for lp in layers[g * k:(g + 1) * k]:
            h = block(lp, h, cfg, ctx, chunk, sink)
        z = ctx.shard(torch.cat([h, x0], dim=-1), "dp", None, None) \
            @ params["shared_proj"].to(h.dtype)
        z = _dense_block(params["shared_block"],
                         ctx.shard(z, "dp", "sp", None), cfg, ctx, positions,
                         sink)
        x = ctx.shard(h + z, "dp", "sp", None)
    return x


def encode(params: Params, cfg, frames: torch.Tensor, *,
           ctx: ModelContext = NULL_CTX) -> torch.Tensor:
    """The encoder (``transformer.py:297-307``): frame embeddings (B, S_enc,
    D) plus sinusoidal positions, ``encoder_layers`` non-causal dense
    blocks, ``ln_enc``.  Runs in the frames' dtype (``forward`` hands it
    frames cast to the compute dtype, ``prefill`` the frames as given).  As
    in the reference, its self-attention also applies RoPE at
    ``arange(S_enc)``.  Under a mesh the output is laid out with the whole
    sequence: every decoder layer's cross K / V reads all of it."""
    enc = frames + sinusoidal_positions(
        frames.shape[1], cfg.d_model, device=frames.device).to(frames.dtype)
    enc = ctx.shard(enc, "dp", "sp", None)
    block = ctx.maybe_remat(_dense_block)
    for lp in unstack(params["encoder_layers"], cfg.encoder_layers):
        enc = block(lp, enc, cfg, ctx, None, causal=False)
    return ctx.shard(norm_apply(cfg.norm, params["ln_enc"], enc), "dp", None,
                     None)


def cross_kv(params: Params, cfg, enc: torch.Tensor
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each decoder layer's cross-attention k / v (B, S_enc, Hkv, hd) of the
    encoder's output, without RoPE."""
    return [kv_project(xl["attn"], enc, cfg.num_kv_heads, cfg.head_dim_)
            for xl in unstack(params["cross_attn"], cfg.num_layers)]


# ---------------------------------------------------------------------------
# forward (prefill / teacher forcing)
# ---------------------------------------------------------------------------

def hidden_states(params: Params, cfg, tokens: torch.Tensor, *,
                  ctx: ModelContext = NULL_CTX, sink: Optional[List] = None,
                  patch_embeds: Optional[torch.Tensor] = None,
                  frame_embeds: Optional[torch.Tensor] = None,
                  cross: Optional[Sequence[Tuple[torch.Tensor,
                                                 torch.Tensor]]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S), positions 0..S-1 -> (final-norm hidden states
    (B, S, D) in the compute dtype, aux loss).  ``sink`` collects each
    layer's decode state in order: attention layers (moe: the dense layers,
    then the MoE layers; audio: the decoder's self-attention), their
    post-RoPE (k, v); ssm, the recurrence's final S and the last position
    of the normed time-mix and channel-mix inputs; hybrid, per group each
    Mamba2 block's (final S, conv tail), then the shared block's post-RoPE
    (k, v).  The aux loss is a float32 scalar, the sum over the MoE layers
    in order (``transformer.py:284-295``), 0 for the other families.  Each
    layer's block runs under ``ctx.maybe_remat``.

    The audio family needs ``frame_embeds`` (B, S_enc, D): they are cast to
    the compute dtype and encoded, and each decoder layer cross-attends to
    its k / v of the encoder's output; or ``cross``, each decoder layer's
    (k, v) as given (``prefill`` passes the cached ones).  A "patch"
    frontend (the vlm family) takes ``patch_embeds`` (B, P, D), P <= S:
    ``merge_patches`` puts them in place of the first P token embeddings;
    without them the tokens run alone, as the reference's serving path
    does.  Other frontends ignore ``patch_embeds``, as the reference's
    ``forward`` does."""
    check_ported(cfg)
    s = tokens.shape[1]
    x = _embed(params["embed"], tokens, ctx).to(compute_dtype(cfg))
    if cfg.frontend == "patch" and patch_embeds is not None:
        x = merge_patches(params, x, patch_embeds, ctx)
    positions = torch.arange(s, device=tokens.device)[None]
    x = ctx.shard(x, "dp", "sp", None)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.family == "ssm":
        block = ctx.maybe_remat(_rwkv6_block)
        for lp in unstack(params["layers"], cfg.num_layers):
            x = block(lp, x, cfg, ctx, _fit_chunk(s, ctx.ssm_chunk), sink)
        return norm_apply(cfg.norm, params["ln_f"], x), aux
    if cfg.family == "hybrid":
        x = _hybrid_stack(params, x, cfg, ctx, positions,
                          _fit_chunk(s, ctx.ssm_chunk), sink)
        return norm_apply(cfg.norm, params["ln_f"], x), aux
    if cfg.is_encoder_decoder:
        if cross is None:
            if frame_embeds is None:
                raise ValueError(f"{cfg.name}: the audio family needs "
                                 f"frame_embeds (B, S_enc, d_model)")
            enc = encode(params, cfg, frame_embeds.to(x.dtype), ctx=ctx)
            cross = cross_kv(params, cfg, enc)
        block = ctx.maybe_remat(_decoder_block)
        for lp, xl, kv in zip(unstack(params["layers"], cfg.num_layers),
                              unstack(params["cross_attn"], cfg.num_layers),
                              cross):
            x = block(lp, xl, x, cfg, ctx, positions, kv, sink)
        return norm_apply(cfg.norm, params["ln_f"], x), aux
    for key, n, moe in attention_stacks(cfg):
        block = ctx.maybe_remat(_moe_block if moe else _dense_block)
        for lp in unstack(params[key], n):
            if moe:
                x, a = block(lp, x, cfg, ctx, positions, sink)
                aux = aux + a
            else:
                x = block(lp, x, cfg, ctx, positions, sink)
    return norm_apply(cfg.norm, params["ln_f"], x), aux


def _embed(table: torch.Tensor, tokens: torch.Tensor,
           ctx: ModelContext) -> torch.Tensor:
    """The lookup of ``tokens`` (B, S) in ``table`` (V, D), in the table's
    dtype.  Under a mesh the table keeps its vocab split (Megatron's
    vocab-parallel embedding; an FSDP split of D is gathered): each rank
    looks up the tokens that fall in its rows, zeros for the others, and
    the parts add over the vocab's mesh dims, exactly, since one part of
    each token is not zero.  Each row's grad stays on the rank holding
    it."""
    if ctx.mesh is None:
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx.dmesh
    t_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in table.placements]
    dims = [i for i, p in enumerate(t_pl) if isinstance(p, Shard)]
    rows = ctx.placements("dp", None)
    grad = [Partial() if isinstance(p, Replicate) and isinstance(r, Shard)
            else p for p, r in zip(t_pl, rows)]

    def local(tbl, tok):
        tok = tok - shard_block(mesh, dims) * tbl.shape[0]
        mine = (tok >= 0) & (tok < tbl.shape[0])
        out = F.embedding(torch.where(mine, tok, 0), tbl).masked_fill(
            ~mine[..., None], 0)
        for i in dims:
            out = _SumOver.apply(out, mesh.get_group(i))
        return out

    fn = local_map(local, out_placements=ctx.placements("dp", None, None),
                   in_placements=(t_pl, rows), in_grad_placements=(grad, rows),
                   device_mesh=mesh)
    return fn(table.redistribute(mesh, t_pl), tokens.redistribute(mesh, rows))


def merge_patches(params: Params, x: torch.Tensor,
                  patch_embeds: torch.Tensor,
                  ctx: ModelContext = NULL_CTX) -> torch.Tensor:
    """The vlm stub frontend (``transformer.py:228-232``): patch embeddings
    (B, P, D) cast to the compute dtype of ``x`` (B, S, D) and projected by
    ``patch_proj`` replace the first P token embeddings.  P > S is refused:
    there the reference's merged sequence is P long against S positions,
    which its RoPE cannot broadcast (ROADMAP.md, deliberate differences).
    Under a mesh both parts of the concatenation are laid out as the
    embeddings are (rows over dp, the rest whole) before the ``cat`` over
    the sequence: ``patch_proj``'s columns are split over tp."""
    n = patch_embeds.shape[1]
    if n > x.shape[1]:
        raise ValueError(f"{n} patch embeddings do not fit a sequence of "
                         f"{x.shape[1]} tokens; they replace the first P "
                         f"token embeddings, so P <= S")
    pe = patch_embeds.to(x.dtype) @ params["patch_proj"].to(x.dtype)
    return torch.cat([ctx.shard(pe, "dp", None, None),
                      ctx.shard(x[:, n:], "dp", None, None)], dim=1)


def logits_from_hidden(params: Params, cfg, x: torch.Tensor,
                       ctx: ModelContext = NULL_CTX) -> torch.Tensor:
    # the sequence is gathered first (under sequence parallelism the final
    # hidden states are split over it): the head's product then splits the
    # vocab alone
    x = ctx.shard(x, "dp", None, None)
    logits = x @ _lm_head(params, cfg).to(x.dtype)
    return ctx.shard(logits, "dp", None, "tp")


def forward(params: Params, cfg, tokens: torch.Tensor, *,
            ctx: ModelContext = NULL_CTX,
            patch_embeds: Optional[torch.Tensor] = None,
            frame_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) in the compute dtype, aux loss);
    the vlm family also takes ``patch_embeds`` (B, P, D), the audio family
    ``frame_embeds`` (B, S_enc, D).

    As in the reference, the aux loss is a float32 scalar, 0 for the dense
    ssm, hybrid, audio and vlm families (only MoE layers add to it)."""
    with ctx.scope():
        x, aux = hidden_states(params, cfg, tokens, ctx=ctx,
                               patch_embeds=patch_embeds,
                               frame_embeds=frame_embeds)
        return logits_from_hidden(params, cfg, x, ctx), aux


def lm_loss(params: Params, cfg, tokens: torch.Tensor, labels: torch.Tensor,
            *, ctx: ModelContext = NULL_CTX, aux_weight: float = 0.01,
            patch_embeds: Optional[torch.Tensor] = None,
            frame_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy in float32 plus ``aux_weight`` x the
    aux loss (``transformer.py:340-349``): (loss, {"nll", "aux"}).

    Training passes the float32 master tree with ``requires_grad``, never
    ``LM.compute_params()`` (detached): the blocks cast each weight to the
    compute dtype inside the graph, so grads reach the masters in float32,
    as the reference's do."""
    logits, aux = forward(params, cfg, tokens, ctx=ctx,
                          patch_embeds=patch_embeds,
                          frame_embeds=frame_embeds)
    if ctx.mesh is None:
        nll = _nll_sum(logits, labels) / labels.numel()
    else:
        nll = _sharded_nll(logits, labels, ctx)
    with ctx.scope():
        return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed next-token cross entropy, float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).sum()


def _sharded_nll(logits, labels, ctx: ModelContext):
    """The mean cross entropy of DTensor logits (B, S, V) and labels (B, S),
    vocab-parallel (Megatron's): the logits keep their vocab split over
    the tp dims (as far as V divides, ``sanitize_spec``) and their rows
    over dp; each rank sums its rows' losses from its own columns
    (``_VocabNLL``), and the sums add over the data-parallel split (a
    partial sum), scaled by the global token count."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, n = ctx.dmesh, labels.numel()
    rows = ctx.placements("dp", None)
    lg_pl, dims = vocab_split(logits, ctx)
    out = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]

    def local(lg, lb):
        if not dims:        # the vocab is whole: the single device's sum
            return _nll_sum(lg, lb) / n
        lo = shard_block(mesh, dims) * lg.shape[-1]
        return _VocabNLL.apply(lg.float(), lb, lo,
                               [mesh.get_group(i) for i in dims]) / n

    fn = local_map(local, out_placements=out, in_placements=(lg_pl, rows),
                   device_mesh=mesh)
    nll = fn(logits.redistribute(mesh, lg_pl),
             labels.redistribute(mesh, rows))
    return nll.redistribute(mesh, [Replicate()] * mesh.ndim)


def vocab_split(logits, ctx: ModelContext) -> Tuple[list, List[int]]:
    """The layout of logits (B, S, V) read vocab-parallel: rows over dp,
    the vocab over the tp dims as far as V divides (``sanitize_spec``; a
    vocab no split divides stays whole); and the mesh dims that split the
    vocab."""
    from torch.distributed.tensor import Shard

    from ..parallel.sharding import P, sanitize_spec, spec_placements
    vocab = sanitize_spec(P(None, None, ctx.axes["tp"]), logits, ctx.mesh)
    pl = spec_placements(P(ctx.axes.get("dp"), None, vocab[2]), ctx.mesh)
    return pl, [i for i, p in enumerate(pl)
                if isinstance(p, Shard) and p.dim == 2]


class _VocabNLL(torch.autograd.Function):
    """Summed cross entropy of local logits (B, S, V_local) float32 holding
    the vocab's columns ``lo`` .. ``lo + V_local`` of ``groups``' ranks:
    the max, the sum of exponentials and the gold logit are reduced over
    the groups; the grad is softmax minus the one-hot of the label, on this
    rank's columns."""

    @staticmethod
    def forward(ctx, lg, labels, lo, groups):
        m = lg.amax(dim=-1)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(lg - m[..., None])
        se = e.sum(dim=-1)
        local = labels.long() - lo
        mine = (local >= 0) & (local < lg.shape[-1])
        idx = torch.where(mine, local, 0)[..., None]
        gold = lg.gather(-1, idx)[..., 0].masked_fill(~mine, 0)
        for g in groups:
            dist.all_reduce(se, group=g)
            dist.all_reduce(gold, group=g)
        ctx.save_for_backward(e.div_(se[..., None]), idx, mine)
        return (m + torch.log(se) - gold).sum()

    @staticmethod
    def backward(ctx, g):
        soft, idx, mine = ctx.saved_tensors
        grad = soft.scatter_add(-1, idx, -mine[..., None].to(soft.dtype))
        return grad * g, None, None, None


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------

# leaves the compute copy keeps in float32, as the reference reads them:
# norm params (norm_apply), the RWKV6 decay base and bonus, which enter
# float32 arithmetic (ssm.py:264 and :100-101), the MoE router, which
# routes in float32 (moe.py:57), and Mamba2's A and dt bias (ssm.py:
# 195-199)
_KEEP_DTYPE = ("scale", "bias", "decay_base", "bonus_u", "router", "a_log",
               "dt_bias")


def _flatten(tree: Params, prefix: str = ""
             ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(leaves by path, paths of the empty subtrees).  A ``nonparam_ln``
    norm is an empty subtree ({}), which has no leaf to carry it."""
    out, empty = {}, []
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            sub, sub_empty = _flatten(v, f"{prefix}{k}/")
            out.update(sub)
            empty += sub_empty
        elif isinstance(v, dict):
            empty.append(prefix + k)
        else:
            out[prefix + k] = v
    return out, empty


def _unflatten(flat: Dict[str, torch.Tensor],
               empty: Sequence[str] = ()) -> Params:
    tree: Params = {}
    for path, v in (*flat.items(), *((p, {}) for p in empty)):
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return tree


class LM(nn.Module):
    """Owns the stacked parameters of one LM (float32 unless ``init`` was
    given another dtype) and calls the functional code.

    ``compute_params()`` is the tree the entry points pass on: in bf16
    configs it holds one bf16 copy of every other leaf, made once (a leaf
    already bf16 is the same tensor, not a copy).  The reference casts the
    same float32 values to bf16 where it uses them, so the copy is
    bit-identical to that cast; the leaves of ``_KEEP_DTYPE`` stay float32,
    as the reference reads them."""

    def __init__(self, cfg, params: Params):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        flat, self._empty = _flatten(params)
        self.weights = nn.ParameterDict({
            path: nn.Parameter(t, requires_grad=False)
            for path, t in flat.items()})
        self._compute: Optional[Params] = None

    @classmethod
    def init(cls, cfg, seed: int = 0, *, device="cuda",
             dtype=torch.float32) -> "LM":
        """``dtype``: the held matrices' (``init_lm``).  Bf16-held weights
        serve a model whose float32 masters would not fit the card: the
        compute copy then aliases them, and equals the float32 LM's."""
        return cls(cfg, init_lm(cfg, seed, device=device, dtype=dtype))

    @property
    def params(self) -> Params:
        return _unflatten(dict(self.weights.items()), self._empty)

    def compute_params(self) -> Params:
        if self._compute is None:
            dt = compute_dtype(self.cfg)
            self._compute = _unflatten({
                path: (w.detach() if path.rsplit("/", 1)[-1] in _KEEP_DTYPE
                       else w.detach().to(dt))
                for path, w in self.weights.items()}, self._empty)
        return self._compute

    def _apply(self, fn, *args, **kwargs):
        self._compute = None          # .to() / .cuda(): the copy is remade
        return super()._apply(fn, *args, **kwargs)

    def forward(self, tokens: torch.Tensor,
                frame_embeds: Optional[torch.Tensor] = None, *,
                patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V); the aux loss is dropped.  The
        audio family also takes ``frame_embeds`` (B, S_enc, D), the vlm
        family ``patch_embeds`` (B, P, D)."""
        return forward(self.compute_params(), self.cfg, tokens,
                       patch_embeds=patch_embeds,
                       frame_embeds=frame_embeds)[0]
