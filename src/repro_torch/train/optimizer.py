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
global norm adds the ranks' sums of squares.  The int8 state, whose blocks run along a leaf's last
axis, is not laid out over a mesh yet (ROADMAP.md queue 1): it raises
there.
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


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantisation along the last axis:
    (q (rows, blocks, 128) int8, scale (rows, blocks, 1) float32)."""
    n = x.shape[-1]
    pad = (-n) % _BLOCK
    xf = F.pad(x.reshape(-1, n).float(), (0, pad))
    xb = xf.reshape(xf.shape[0], -1, _BLOCK)
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = (q.float() * scale).reshape(q.shape[0], -1)
    return x[:, :shape[-1]].reshape(shape)


def _store(x: torch.Tensor, dtype: str):
    if dtype == "int8" and x.dim() >= 1 and x.numel() >= _BLOCK:
        if is_dtensor(x):
            raise NotImplementedError(
                "AdamW state_dtype int8 under a mesh is not ported yet "
                "(ROADMAP.md queue 1); use float32 or bfloat16 state")
        return _q8(x)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.float()


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
    (``local_map``): the grad, param and moments share its layout."""
    step = state.step + 1
    stepf = step.float()
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
             if cfg.clip_norm > 0 else 1.0)

    def upd(g, p, m_s, v_s):
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
        return new_p, _store(m, cfg.state_dtype), _store(v, cfg.state_dtype)

    def upd_leaf(g, p, m_s, v_s):
        if not is_dtensor(p):
            return upd(g, p, m_s, v_s)
        from torch.distributed.tensor.experimental import local_map
        pl, mesh = p.placements, p.device_mesh
        return local_map(upd, out_placements=(pl, pl, pl),
                         in_placements=(pl, pl, pl, pl), device_mesh=mesh)(
            g.redistribute(mesh, pl), p, m_s, v_s)

    out = [upd_leaf(g, p, m, v) for (_, g), p, m, v in zip(
        flatten(grads), leaves(params), leaves(state.m), leaves(state.v))]
    return (unflatten(params, (o[0] for o in out)),
            AdamWState(step, unflatten(params, (o[1] for o in out)),
                       unflatten(params, (o[2] for o in out))),
            {"lr": lr, "grad_norm": gnorm})
