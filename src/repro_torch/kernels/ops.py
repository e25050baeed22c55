"""Public entry to the port's kernels, differentiable.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the kernel's plain
version, both through the kernel's registered op
(``torch.ops.repro_torch.flash_attention_fwd`` / ``rwkv6_fused_fwd``,
below): its ``cuda`` kernel is the wrapper, its ``cpu`` kernel the plain
version, its fake kernel the outputs' shapes, dtypes and strides, and a
FLOP formula is registered for it (``flash_attention.flops``,
``rwkv6.flops``).  So dispatch modes (``launch/hlo_analysis.py``'s
recorder, fake tensors) see each call as one op, and a fake tensor never
reaches a ctypes call.  There is no fallback: a CUDA input that the kernel
refuses raises.
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

from torch.utils.flop_counter import register_flop_formula

from ..device import is_dtensor
from . import flash_attention as _fa
from . import rwkv6 as _kr
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
# the registered ops
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int]) -> torch.Tensor:
    """The attention forward as one op: the plain version on the CPU, the
    kernel on CUDA; a contiguous (B, Sq, Hq, hd) in q's dtype."""
    return flash_attention_plain(q, k, v, causal, window)


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, causal, window):
    return flash_attention(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window, *,
                           out_shape=None, **kwargs) -> int:
    b, sq, hq, hd = q_shape
    return _fa.flops(b, sq, k_shape[1], hq, hd, causal, window)


def _rwkv6_out(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty (B, H, T, V) output in q's dtype laid out as the kernel
    writes it: a view of a (B, T, H, V) tensor."""
    b, h, t, _ = q.shape
    return q.new_empty((b, t, h, dv)).transpose(1, 2)


@torch.library.custom_op("repro_torch::rwkv6_fused_fwd", mutates_args=(),
                         device_types="cpu")
def rwkv6_fused_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_decay: torch.Tensor, bonus: Optional[torch.Tensor],
                   initial_state: Optional[torch.Tensor], chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused recurrence as one op at ``chunk``: the plain version on the
    CPU, the kernel on CUDA; (out (B, H, T, V) in q's dtype in the kernel's
    layout, final S (B, H, K, V))."""
    out, s = rwkv6_fused_plain(q, k, v, log_decay, bonus=bonus, chunk=chunk,
                               initial_state=initial_state)
    return _rwkv6_out(q, v.shape[-1]).copy_(out), s.contiguous()


@rwkv6_fused_op.register_kernel("cuda")
def _rwkv6_fused_cuda(q, k, v, log_decay, bonus, initial_state, chunk):
    return rwkv6_fused(q, k, v, log_decay, bonus=bonus, chunk=chunk,
                       initial_state=initial_state)


@rwkv6_fused_op.register_fake
def _rwkv6_fused_fake(q, k, v, log_decay, bonus, initial_state, chunk):
    b, h, _, dk = q.shape
    dv = v.shape[-1]
    wide = torch.promote_types(q.dtype, torch.float32)
    return _rwkv6_out(q, dv), q.new_empty((b, h, dk, dv), dtype=wide)


@register_flop_formula(torch.ops.repro_torch.rwkv6_fused_fwd)
def _rwkv6_fused_flops(q_shape, k_shape, v_shape, ld_shape, bonus_shape,
                       s0_shape, chunk, *, out_shape=None, **kwargs) -> int:
    b, h, t, dk = q_shape
    return _kr.flops(b, h, t, dk, v_shape[-1], chunk)


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
    contiguous local tensors.  A DTensor grad is copied: it reports the
    strides of its global shape, so ``contiguous()`` may leave its local
    tensor transposed, and the ``reshape`` in a product's backward then
    takes the view path on it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            return g.clone(memory_format=torch.contiguous_format)
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose grad's local tensor is made contiguous under a mesh: for
    a tensor read through a transposed view."""
    return _ContiguousGrad.apply(x) if is_dtensor(x) else x


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
        return flash_attention_op(q, k, v, causal, window)

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
    chunk scan with its bonus diagonal (``repro/models/ssm.py:36-100``).
    Both passes run at the chunk asked for, on the card as on the CPU, as
    the reference's forward and recompute do."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, bonus, initial_state, chunk: int):
        ctx.save_for_backward(q, k, v, log_decay, bonus, initial_state)
        ctx.chunk = chunk
        return rwkv6_fused_op(q, k, v, log_decay, bonus, initial_state, chunk)

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
    and whole heads through ``local_map`` around :class:`_Rwkv6Mix`, as
    :func:`_sharded_attention` does for attention.  The split of the heads
    is the first of v's, k's and q's that has one: Mamba2's q is C
    broadcast over the heads and its k and log decay come from the
    replicated B, dt and A, so there only v (the conv output) is split.  A
    (B, H, ...) operand split over the same mesh dims takes that layout;
    one whole over them enters whole and each rank slices out its own heads
    (a local slice, no collective), its grad then a partial sum over the
    split, as :func:`_kv_layout` makes a whole K / V's.  The bonus (H, K)
    takes the split of the heads, and its grad is a partial sum over the
    batch's split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def heads_split(t):
        return any(isinstance(p, Shard) and p.dim == 1 for p in t.placements)
    ref = next((t for t in (v, k, q) if heads_split(t)), q)
    pl, index, parts = _head_layout(ref, 0, 1)
    heads = q.shape[1]
    if heads % parts:
        raise ValueError(f"rwkv6_mix: {heads} heads do not split {parts} "
                         f"ways")
    split = [isinstance(p, Shard) and p.dim == 1 for p in pl]
    whole_pl = [Replicate() if s else p for s, p in zip(split, pl)]
    whole_grad = [Partial() if s else p for s, p in zip(split, pl)]
    bonus_pl = [Shard(0) if s else Replicate() for s in split]
    # the bonus has no batch dim: its grad is a partial sum over the batch's
    bonus_grad = [Partial() if isinstance(p, Shard) and p.dim == 0 else b
                  for p, b in zip(pl, bonus_pl)]
    mesh = ref.device_mesh
    ops = [q, k, v, log_decay, bonus, initial_state]
    whole = [t is not None and t is not bonus and all(
        isinstance(p, Replicate) for s, p in zip(split, t.placements) if s)
        for t in ops]
    lays = [None if t is None else bonus_pl if t is bonus else
            whole_pl if w else pl for t, w in zip(ops, whole)]
    grads = [bonus_grad if t is bonus and t is not None else
             whole_grad if w else lay for t, w, lay in zip(ops, whole, lays)]
    ins = [None if t is None else t.redistribute(mesh, lay)
           for t, lay in zip(ops, lays)]
    local_heads = heads // parts

    def local(*xs):
        xs = [x.narrow(1, index * local_heads, local_heads) if w else x
              for x, w in zip(_local_ins(*xs), whole)]
        _check_device("rwkv6_mix", *xs)
        return _Rwkv6Mix.apply(*xs, chunk)

    return local_map(local, out_placements=(pl, pl),
                     in_placements=tuple(lays),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*ins)


def rwkv6_mix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_decay: torch.Tensor, *,
              bonus: Optional[torch.Tensor] = None,
              chunk: int = 64) -> torch.Tensor:
    """The reference's ``rwkv6_mix(implementation="pallas")``: the output of
    :func:`rwkv6_mix_state` without the final state."""
    return rwkv6_mix_state(q, k, v, log_decay, bonus=bonus, chunk=chunk)[0]
