"""Public entry to the port's kernels, differentiable.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the kernel's plain
version.  There is no fallback: a CUDA input that the kernel refuses raises.
Each model kernel sits inside an autograd ``Function`` whose backward
recomputes through the reference's differentiable plain formulation, as the
reference trains its Pallas forward (``repro/kernels/ops.py:41-72``): the
JAX package has no backward kernel to port.  Under a mesh the entry points
take DTensors and run the Function on each rank's local, whole heads
through ``local_map`` (the reference leaves the split to GSPMD, which may
cut a head's columns; the kernels take whole heads); a DTensor never
reaches a kernel.  The kernels' own wrappers fill
their outputs through ``ctypes`` and refuse to run where autograd would need
a graph (``build.refuse_grad``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import is_dtensor
from .flash_attention import flash_attention, flash_attention_plain
from .rwkv6 import rwkv6_fused, rwkv6_fused_plain


def _check_device(name: str, *xs: Optional[torch.Tensor]) -> None:
    for x in xs:
        if x is None:
            continue
        if is_dtensor(x):
            raise TypeError(
                f"{name}: got a DTensor; a kernel takes local, whole-head "
                f"tensors, and the entry point (kernels.ops) runs it on each "
                f"rank's shard through local_map")
        if not x.is_cuda and x.device.type != "cpu":
            raise ValueError(f"{name}: no path for device {x.device}")


# ---------------------------------------------------------------------------
# the kernel boundary under a mesh
# ---------------------------------------------------------------------------

def _head_layout(x, batch_dim: int, head_dim: int):
    """Placements of ``x`` with every mesh dim that shards anything but the
    batch or head dim replicated, and the rank's index along the heads'
    split (mesh dims in order, major first) with that split's size."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    out, index, parts = [], 0, 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == batch_dim:
            out.append(pl)
        elif isinstance(pl, Shard) and pl.dim == head_dim:
            out.append(pl)
            index = index * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
        else:
            out.append(Replicate())
    return out, index, parts


def _kv_layout(q_pl, kv_heads: int, parts: int, head_dim: int):
    """K / V placements for q's: the same split of the heads where the KV
    heads divide into it; else whole (replicated over the heads' split),
    each rank then taking the KV heads its q heads read.  The grad of a
    whole K / V is a partial sum over that split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if kv_heads % parts == 0:
        return q_pl, q_pl, False
    pl = [Replicate() if isinstance(p, Shard) and p.dim == head_dim else p
          for p in q_pl]
    grad = [Partial() if isinstance(p, Shard) and p.dim == head_dim else p
            for p in q_pl]
    return pl, grad, True


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its grad contiguous: a local
    shard's grad leaves ``local_map`` for DTensor view ops, which need
    contiguous local tensors."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_ins(*xs):
    return [None if x is None else _ContiguousGrad.apply(x) for x in xs]


def _kv_for_rank(k, v, hq_local: int, index: int, group: int):
    """The KV heads that q heads [index·hq_local, (index+1)·hq_local) read
    (kv-major GQA: q head h reads kv head h // group)."""
    lo = index * hq_local // group
    hi = ((index + 1) * hq_local - 1) // group + 1
    if hq_local % group and group % hq_local:
        raise ValueError(f"attention: {hq_local} local q heads read KV heads "
                         f"{lo}..{hi - 1} unevenly (GQA group {group})")
    return k[:, :, lo:hi], v[:, :, lo:hi]


class _FlashAttention(torch.autograd.Function):
    """Flash attention forward (the kernel, or its plain version on the CPU)
    with the reference's recompute backward: autograd through
    ``models.attention.blocked_attention`` on the saved q, k, v (GQA
    inside, as the kernel does it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.is_cuda:
            return flash_attention(q, k, v, causal=causal, window=window)
        return flash_attention_plain(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        from ..models.attention import blocked_attention  # models import ops
        with torch.enable_grad():
            ins = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            out = blocked_attention(*ins, causal=ctx.causal,
                                    window=ctx.window)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd).

    DTensors (under a mesh) run the kernel on each rank's local heads
    (:func:`_sharded_attention`)."""
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal, window)
    _check_device("attention", q, k, v)
    return _FlashAttention.apply(q, k, v, causal, window)


def _sharded_attention(q, k, v, causal: bool, window: Optional[int]):
    """Attention on DTensors: q is laid out with its batch and heads split
    and everything else whole; each rank's kernel runs on its local batch
    rows and q heads through ``local_map`` around :class:`_FlashAttention`
    (so the backward recomputes on the local heads, as on one device).
    K / V take q's split of the heads where their heads divide into it;
    otherwise they are made whole and each rank slices the KV heads its q
    heads read."""
    from torch.distributed.tensor.experimental import local_map
    q_pl, index, parts = _head_layout(q, 0, 2)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % parts:
        raise ValueError(f"attention: {hq} q heads do not split {parts} ways")
    kv_pl, kv_grad, whole = _kv_layout(q_pl, hkv, parts, 2)
    mesh = q.device_mesh
    q = q.redistribute(mesh, q_pl)
    k, v = (t.redistribute(mesh, kv_pl) for t in (k, v))

    def local(ql, kl, vl):
        ql, kl, vl = _local_ins(ql, kl, vl)
        if whole:
            kl, vl = _kv_for_rank(kl, vl, ql.shape[2], index, hq // hkv)
        _check_device("attention", ql, kl, vl)
        return _FlashAttention.apply(ql, kl, vl, causal, window)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


# ---------------------------------------------------------------------------
# rwkv6 / mamba2 chunked recurrence
# ---------------------------------------------------------------------------

class _Rwkv6Mix(torch.autograd.Function):
    """The fused recurrence (the kernel, or ``rwkv6_fused_plain`` on the
    CPU) -> (out, final S), both differentiable; the backward recomputes
    through ``models.ssm.chunked_linear_attention_scan``, the reference's
    chunk scan with its bonus diagonal (``repro/models/ssm.py:36-100``)."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, bonus, initial_state, chunk: int):
        ctx.save_for_backward(q, k, v, log_decay, bonus, initial_state)
        ctx.chunk = chunk
        run = rwkv6_fused if q.is_cuda else rwkv6_fused_plain
        return run(q, k, v, log_decay, bonus=bonus, chunk=chunk,
                   initial_state=initial_state)

    @staticmethod
    def backward(ctx, g_out, g_state):
        from ..models.ssm import chunked_linear_attention_scan
        with torch.enable_grad():
            ins = [None if x is None else x.detach().requires_grad_()
                   for x in ctx.saved_tensors]
            q, k, v, ld, u, s0 = ins
            b, h, _, dk = q.shape
            out, S = chunked_linear_attention_scan(
                q, k, v, ld, bonus=u, chunk=ctx.chunk,
                initial_state=None if s0 is None else
                s0.reshape(b, h, dk, v.shape[-1]))
            grads = iter(torch.autograd.grad(
                (out, S), [x for x in ins if x is not None],
                (g_out, g_state)))
        return (*(None if x is None else next(grads) for x in ins), None)


def rwkv6_mix_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_decay: torch.Tensor, *,
                    bonus: Optional[torch.Tensor] = None, chunk: int = 64,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v (B, H, T, K/V), log_decay (B, H, T, K) <= 0, bonus (H, K) or
    None, initial_state (B, H, K, V) or None -> (out (B, H, T, V) in q's
    dtype, final state (B, H, K, V) float32).

    On the card the fused kernel reads the model's tensors as they are and
    does the decay precompute and the bonus diagonal itself; on the CPU the
    plain version computes them as the reference does (``ops.py:97-123``)."""
    if not is_dtensor(q):
        _check_device("rwkv6_mix", q, k, v, log_decay, bonus, initial_state)
    if q.shape[2] % chunk:
        raise ValueError(f"rwkv6_mix: T={q.shape[2]} must be a multiple of "
                         f"chunk={chunk}")
    if is_dtensor(q):
        return _sharded_rwkv6_mix(q, k, v, log_decay, bonus, initial_state,
                                  chunk)
    return _Rwkv6Mix.apply(q, k, v, log_decay, bonus, initial_state, chunk)


def _sharded_rwkv6_mix(q, k, v, log_decay, bonus, initial_state,
                       chunk: int):
    """The recurrence on DTensors: each rank runs it on its local batch rows
    and heads through ``local_map`` around :class:`_Rwkv6Mix`, as
    :func:`_sharded_attention` does for attention.  Every (B, H, ...)
    operand takes q's layout; the bonus (H, K) its split of the heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl, _, _ = _head_layout(q, 0, 1)
    bonus_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 1
                else Replicate() for p in pl]
    mesh = q.device_mesh
    ops = [q, k, v, log_decay, bonus, initial_state]
    layouts = [pl, pl, pl, pl, bonus_pl, pl]
    ins = [None if t is None else t.redistribute(mesh, lay)
           for t, lay in zip(ops, layouts)]

    def local(*xs):
        xs = _local_ins(*xs)
        _check_device("rwkv6_mix", *xs)
        return _Rwkv6Mix.apply(*xs, chunk)

    lays = tuple(None if t is None else lay for t, lay in zip(ops, layouts))
    return local_map(local, out_placements=(pl, pl), in_placements=lays,
                     in_grad_placements=lays, device_mesh=mesh)(*ins)


def rwkv6_mix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_decay: torch.Tensor, *,
              bonus: Optional[torch.Tensor] = None,
              chunk: int = 64) -> torch.Tensor:
    """The reference's ``rwkv6_mix(implementation="pallas")``: the output of
    :func:`rwkv6_mix_state` without the final state."""
    return rwkv6_mix_state(q, k, v, log_decay, bonus=bonus, chunk=chunk)[0]
