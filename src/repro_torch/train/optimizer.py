"""AdamW in PyTorch: schedule, global-norm clipping, int8 state option.

The port of ``repro/train/optimizer.py``: the same update, op for op, on
nested dicts of tensors.  Optimizer state may be stored as float32, bf16 or
blockwise int8 (``_q8``: symmetric, 128 values a block along the last
axis, round half to even as ``jnp.round``); an int8 leaf is the pair
(q int8, scale float32).  Decoupled weight decay applies to leaves of
``ndim >= 2`` only (not norms or biases).  Functional, as the reference:
``adamw_update`` returns new params and state and changes none.

On DTensor leaves (under a mesh) the state takes each param's layout,
each leaf's update runs on its local shards (``local_map``) and the
global norm adds the ranks' sums of squares.  The int8 state there keeps
the leaf's leading dims and turns its last axis into (blocks, 128): q
(*lead, blocks, 128), scale (*lead, blocks, 1), the blocks of the leaf's
*global* last axis, so the values are the reference's (q bit-identical,
scale exact).  The leading dims keep the param's placements.  A split of
the last axis moves to the blocks where every shard's width is a multiple
of 128 (the blocks then never straddle two shards); otherwise the state
keeps that axis whole on each rank, and the leaf's update gathers its grad
and param over those mesh dims and quantizes whole rows
(:func:`int8_layout`).  Whether a leaf is stored int8 is decided on its
global size, as the reference decides it.  ``bridge.py`` and the checkpoint
reshape this layout to and from the reference's (rows, blocks, 128) /
(rows, blocks, 1), which a leaf with no mesh keeps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import is_dtensor
from .tree import Tree, flatten, leaves, tree_map, unflatten


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"       # float32 | bfloat16 | int8


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to ``min_lr_ratio * lr``;
    float32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog.clamp(0, 1)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# blockwise int8 storage
# ---------------------------------------------------------------------------

_BLOCK = 128


def _q8(x: torch.Tensor, lead: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantisation along the last axis:
    (q (rows, blocks, 128) int8, scale (rows, blocks, 1) float32), or with
    ``lead`` (*x.shape[:-1], blocks, 128) / (..., blocks, 1)."""
    n = x.shape[-1]
    pad = (-n) % _BLOCK
    xf = F.pad(x.reshape(-1, n).float(), (0, pad))
    xb = xf.reshape(xf.shape[0], -1, _BLOCK)
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    if lead:
        blocks = xb.shape[1]
        return (q.reshape(*x.shape[:-1], blocks, _BLOCK),
                scale.reshape(*x.shape[:-1], blocks, 1))
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = (q.float() * scale).reshape(-1, q.shape[-2] * q.shape[-1])
    return x[:, :shape[-1]].reshape(shape)


def stores_int8(x: torch.Tensor, dtype: str) -> bool:
    """Whether a state leaf like ``x`` is stored as int8: ``x``'s global
    size (a DTensor's ``numel`` is its global one) of at least a block."""
    return dtype == "int8" and x.dim() >= 1 and x.numel() >= _BLOCK


def _store(x: torch.Tensor, dtype: str, q8: bool = None, lead: bool = False):
    """``x`` stored as ``dtype``; ``q8`` (int8 or not) as the global leaf
    decides it, by default from ``x`` itself (a leaf with no mesh)."""
    if q8 is None:
        q8 = stores_int8(x, dtype)
    if q8:
        return _q8(x, lead)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.float()


def int8_layout(shape, mesh, placements) -> list:
    """The placements of the int8 state (q (*lead, blocks, 128), scale
    (*lead, blocks, 1)) of a leaf of global ``shape`` laid out as
    ``placements`` on ``mesh``: the leaf's own, where its last axis is
    whole or split into shards whose widths are multiples of 128
    (``Shard(ndim - 1)`` then splits the blocks); else with the last axis's
    splits replicated, so each rank holds whole rows."""
    from torch.distributed.tensor import Replicate, Shard
    last = len(shape) - 1
    cuts = [i for i, pl in enumerate(placements)
            if isinstance(pl, Shard) and pl.dim == last]
    width = shape[-1] // math.prod(mesh.size(i) for i in cuts)
    if not cuts or width % _BLOCK == 0:
        return list(placements)
    return [Replicate() if i in cuts else pl
            for i, pl in enumerate(placements)]


def int8_shapes(shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The global (q, scale) shapes of a leaf of ``shape`` under a mesh."""
    blocks = -(-shape[-1] // _BLOCK)
    lead = tuple(shape[:-1])
    return (*lead, blocks, _BLOCK), (*lead, blocks, 1)


def _int8_zeros(p):
    """The int8 state of zeros for DTensor leaf ``p``: q 0, scale 1e-12,
    as the reference's ``_q8`` stores a zero block."""
    from torch.distributed.tensor import full
    mesh = p.device_mesh
    pl = int8_layout(p.shape, mesh, p.placements)
    q_shape, s_shape = int8_shapes(p.shape)
    return (full(q_shape, 0, dtype=torch.int8, device_mesh=mesh,
                 placements=pl),
            full(s_shape, 1e-12, dtype=torch.float32, device_mesh=mesh,
                 placements=pl))


def _load(stored, shape, dtype: str) -> torch.Tensor:
    if isinstance(stored, tuple):
        return _dq8(stored[0], stored[1], shape)
    return stored.float()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32, on the params' device
    m: Any
    v: Any


def adamw_init(params: Tree, cfg: OptimizerConfig) -> AdamWState:
    def zeros(p):
        if is_dtensor(p) and stores_int8(p, cfg.state_dtype):
            return _int8_zeros(p)
        return _store(torch.zeros_like(p, dtype=torch.float32),
                      cfg.state_dtype)
    first = leaves(params)[0]
    if is_dtensor(first):
        first = first.to_local()
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Tree) -> torch.Tensor:
    ls = leaves(tree)
    if ls and is_dtensor(ls[0]):
        return _sharded_global_norm(ls)
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in ls))


def _sharded_global_norm(ls) -> torch.Tensor:
    """The global norm of DTensor leaves laid out on one mesh (shards and
    replicas, no partial sums): each rank sums the squares of its shards,
    each divided by the number of ranks holding the same shard, and the
    sums add over every mesh dim.  A plain tensor."""
    from torch.distributed.tensor import Replicate
    mesh = ls[0].device_mesh
    total = torch.zeros((), dtype=torch.float32,
                        device=ls[0].to_local().device)
    for g in ls:
        replicas = math.prod(mesh.size(i) for i, p in enumerate(g.placements)
                             if isinstance(p, Replicate))
        total = total + torch.sum(torch.square(g.to_local().float())) \
            / replicas
    for i in range(mesh.ndim):
        dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 cfg: OptimizerConfig) -> Tuple[Tree, AdamWState, Dict]:
    """On DTensor leaves each leaf's update runs on its local shards
    (``local_map``): the grad, param and moments share its layout (an int8
    state's, :func:`int8_layout`, where it keeps the last axis
    whole)."""
    step = state.step + 1
    stepf = step.float()
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
             if cfg.clip_norm > 0 else 1.0)

    def upd(g, p, m_s, v_s, q8=None, lead=False):
        g = g.float() * scale
        m = _load(m_s, g.shape, cfg.state_dtype)
        v = _load(v_s, g.shape, cfg.state_dtype)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / (1 - cfg.b1 ** stepf)
        vh = v / (1 - cfg.b2 ** stepf)
        u = mh / (torch.sqrt(vh) + cfg.eps)
        # decoupled weight decay on matrices only (not norms / biases)
        if p.dim() >= 2:
            u = u + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * u).to(p.dtype)
        return (new_p, _store(m, cfg.state_dtype, q8, lead),
                _store(v, cfg.state_dtype, q8, lead))

    def upd_leaf(g, p, m_s, v_s):
        if not is_dtensor(p):
            return upd(g, p, m_s, v_s)
        from torch.distributed.tensor.experimental import local_map
        pl, mesh = p.placements, p.device_mesh
        if not isinstance(m_s, tuple):
            return local_map(upd, out_placements=(pl, pl, pl),
                             in_placements=(pl, pl, pl, pl),
                             device_mesh=mesh)(g.redistribute(mesh, pl), p,
                                               m_s, v_s)
        # int8: the moments' (q, scale) pass as four tensors, and where the
        # state keeps the last axis whole the grad and param come whole too
        spl = int8_layout(p.shape, mesh, pl)

        def run(g_, p_, mq, ms, vq, vs):
            new_p, m, v = upd(g_, p_, (mq, ms), (vq, vs), True, True)
            return (new_p, *m, *v)
        out = local_map(run, out_placements=(spl,) * 5,
                        in_placements=(spl,) * 6, device_mesh=mesh)(
            g.redistribute(mesh, spl), p.redistribute(mesh, spl), *m_s,
            *v_s)
        new_p = out[0] if list(spl) == list(pl) else \
            out[0].redistribute(mesh, pl)
        return new_p, out[1:3], out[3:5]

    out = [upd_leaf(g, p, m, v) for (_, g), p, m, v in zip(
        flatten(grads), leaves(params), leaves(state.m), leaves(state.v))]
    return (unflatten(params, (o[0] for o in out)),
            AdamWState(step, unflatten(params, (o[1] for o in out)),
                       unflatten(params, (o[2] for o in out))),
            {"lr": lr, "grad_norm": gnorm})
