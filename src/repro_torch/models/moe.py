"""Mixture-of-Experts layer: top-k routing, capacity, shared experts.

The port of ``repro/models/moe.py``'s two paths, with the same semantics:

  * ``moe_apply_dense``: one device; capacity-based dispatch by scatter /
    gather, the experts applied as three batched products over the stacked
    ``(E, D, F)`` weights (plain ``torch.bmm``: no Pallas kernel stands
    behind them in the reference either).
  * ``moe_apply_a2a``: expert parallelism, run per rank inside
    ``local_map`` (the reference runs it inside ``shard_map``): each rank
    routes its own slice of the tokens into per-expert capacity slots, an
    ``all_to_all_single`` over the EP group sends each slot block to the
    rank holding its experts, the local experts run, and the inverse
    all-to-all brings the outputs back.  This emits the pairwise AlltoAll
    traffic the paper's vClos scheduler certifies contention-free (§5.3).

Routing is the reference's to the bit where the float32 logits agree:
softmax top-k (``sorted=True``: column 0 is top-1), gates renormalised with
a 1e-9 floor, the Switch load-balance aux loss, and each (token, choice)
pair's slot in its expert, its rank among the earlier pairs of that
expert in token-major order (the reference's column-major one-hot cumsum,
here a stable sort), so earlier tokens win capacity.  The router is
float32 whatever the compute dtype, as in the reference: a bf16 router
changes top-k decisions, not only their rounding.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .common import Params, dense_init
from .mlp import mlp_apply, mlp_init


def moe_init(gen: torch.Generator, d_model: int, num_experts: int,
             d_ff_expert: int, num_shared: int, *, lead=(),
             dtype=torch.float32) -> Params:
    """Stacked expert weights ``(*lead, E, D, F)`` / ``(*lead, E, F, D)``,
    gated SiLU; the router ``(*lead, D, E)`` is always float32; the shared
    experts are one gated-SiLU MLP of width ``d_ff_expert * num_shared``."""
    experts = (*lead, num_experts)
    p = {
        "router": dense_init(gen, d_model, num_experts, lead=lead),
        "w_up": dense_init(gen, d_model, d_ff_expert, lead=experts,
                           dtype=dtype),
        "w_gate": dense_init(gen, d_model, d_ff_expert, lead=experts,
                             dtype=dtype),
        "w_down": dense_init(gen, d_ff_expert, d_model, lead=experts,
                             dtype=dtype),
    }
    if num_shared:
        p["shared"] = mlp_init(gen, d_model, d_ff_expert * num_shared,
                               "silu", lead=lead, dtype=dtype)
    return p


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, top_k: int,
           num_experts: int, capacity: int):
    """x_flat (T, D) -> (expert_idx (T, k) int64, gates (T, k) float32,
    slot (T, k) position within the expert, keep (T, k) bool, aux float32
    scalar)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_idx[:, 0], num_experts).float().mean(dim=0)
    aux = num_experts * torch.sum(me * ce)
    slot = _slots(expert_idx.reshape(-1), num_experts).reshape(
        expert_idx.shape)
    return expert_idx, gates, slot, slot < capacity, aux


def _slots(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each pair's rank among the pairs of its expert, in flat (token-major)
    order: the reference's column cumsum of a (T·k, E) one-hot
    (``moe.py:66-72``), taken by a stable sort.  PyTorch's cumsum down
    T·k rows runs one thread per expert column on the card
    (``chip_smoke.py`` times both at deepseek's prefill)."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, torch.arange(
        num_experts, device=flat_e.device))
    slot = torch.empty_like(flat_e)
    slot[order] = torch.arange(flat_e.numel(),
                               device=flat_e.device) - first[sorted_e]
    return slot


def _capacity(t_tokens: int, top_k: int, num_experts: int,
              factor: float) -> int:
    cap = int(math.ceil(t_tokens * top_k * factor / num_experts))
    return max(8, ((cap + 7) // 8) * 8)  # pad to 8 for clean tiling


def _expert_ffn(w_up: torch.Tensor, w_gate: torch.Tensor,
                w_down: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """h (E, C, D) with stacked expert weights (E, D, F) -> (E, C, D)."""
    up = torch.bmm(h, w_up.to(h.dtype))
    act = F.silu(torch.bmm(h, w_gate.to(h.dtype))) * up
    return torch.bmm(act, w_down.to(h.dtype))


def moe_apply_dense(params: Params, x: torch.Tensor, cfg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux float32 scalar).

    All B·S tokens are routed against one capacity.  Kept pairs scatter to
    unique rows of an ``(E·cap + 1, D)`` buffer, so their rows are exact;
    dropped pairs all land on the scratch row, which is never read.  The
    scatter writes (``index_put`` without accumulation) where the
    reference adds (``.at[].add``): both give every kept row its token, and
    the writes need no atomics, which the dropped pairs would contend for
    on the scratch row."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    cap = _capacity(t, k, e, cfg.moe_capacity_factor)
    expert_idx, gates, slot, keep, aux = _route(
        params["router"], x_flat, k, e, cap)
    dst = torch.where(keep, expert_idx * cap + slot, e * cap).reshape(-1)
    buf = x.new_zeros((e * cap + 1, d)).index_put(
        (dst,), x_flat.repeat_interleave(k, dim=0))
    out = _expert_ffn(params["w_up"], params["w_gate"], params["w_down"],
                      buf[:e * cap].reshape(e, cap, d))
    out_flat = torch.cat([out.reshape(e * cap, d), x.new_zeros((1, d))])
    fetched = out_flat[dst].reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", fetched, (gates * keep).to(x.dtype))
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, "silu").reshape(-1, d)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# expert-parallel path (per rank, inside local_map)
# ---------------------------------------------------------------------------

a2a_calls = 0     # forward all-to-alls since the last reset (smoke)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits along dim 0; its backward is
    the same exchange of the grads."""

    @staticmethod
    def forward(ctx, x, group):
        global a2a_calls
        a2a_calls += 1
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _SumOver(torch.autograd.Function):
    """Sum of partial results over ``group``; what follows is replicated
    over the group, so each part's grad is the sum's grad."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Megatron's "f": the identity forward into work split over ``group``;
    the backward sums the parts' partial grads over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOver(torch.autograd.Function):
    """Mean over every rank of ``groups`` (one group per mesh dim that
    splits the tokens); what follows is replicated, so each rank's grad is
    1 / ranks of the mean's."""

    @staticmethod
    def forward(ctx, x, groups):
        out = x.clone()
        n = 1
        for g in groups:
            dist.all_reduce(out, group=g)
            n *= dist.get_world_size(g)
        ctx.n = n
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_apply_a2a(params: Params, x: torch.Tensor, cfg, *, mesh,
                  ep_axis: str, tp_axis: Optional[str] = None,
                  mean_axes: Optional[Sequence[str]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank MoE with explicit AlltoAll, on local tensors of ``mesh``.

    ``params["w_up"]`` etc. arrive as this rank's shard: (E_local, D,
    F_local).  ``x`` (B_local, S_local, D) is this rank's slice of the
    batch and of the sequence over the EP axis: every EP peer dispatches a
    distinct token slice, so the AlltoAll carries only real work.  The
    capacity is the local token count's, as in the reference.  With
    ``tp_axis`` the experts' F is split over it and the partial sums (the
    shared experts' too) are added over that axis; the tokens enter the
    experts through ``_CopyTo``, so their grads, partial over F, are added
    over it too (the router's are whole on every rank).  ``aux`` is
    averaged over ``mean_axes``, the axes that split the tokens: it is the
    same on every rank of the others."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    # an EP axis of size 1 is not on the mesh (parallel.sharding.
    # compute_mesh): the exchange is then the identity
    ep_group = (mesh.get_group(ep_axis) if ep_axis in mesh.mesh_dim_names
                else None)
    ep = 1 if ep_group is None else dist.get_world_size(ep_group)
    e_local = e // ep
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    cap = _capacity(t, k, e, cfg.moe_capacity_factor)
    expert_idx, gates, slot, keep, aux = _route(
        params["router"], x_flat, k, e, cap)
    x_e = x if tp_axis is None else _CopyTo.apply(x, mesh.get_group(tp_axis))
    dst = torch.where(keep, expert_idx * cap + slot, e * cap).reshape(-1)
    buf = x.new_zeros((e * cap + 1, d)).index_put(
        (dst,), x_e.reshape(-1, d).repeat_interleave(k, dim=0))
    send = buf[:e * cap].reshape(ep, e_local * cap, d)
    # ---- AlltoAll: send[j] goes to expert shard j (paper §5.3 pattern) ----
    recv = send if ep_group is None else _AllToAll.apply(send, ep_group)
    # recv: (ep source, e_local·cap, d), tokens from every source shard
    h = recv.reshape(ep, e_local, cap, d).transpose(0, 1) \
            .reshape(e_local, ep * cap, d)
    out = _expert_ffn(params["w_up"], params["w_gate"], params["w_down"], h)
    if tp_axis is not None:
        out = _SumOver.apply(out, mesh.get_group(tp_axis))
    out = out.reshape(e_local, ep, cap, d).transpose(0, 1) \
             .reshape(ep, e_local * cap, d)
    back = out if ep_group is None else _AllToAll.apply(out, ep_group)
    out_flat = torch.cat([back.reshape(e * cap, d), x.new_zeros((1, d))])
    fetched = out_flat[dst].reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", fetched, (gates * keep).to(x.dtype))
    if "shared" in params:
        sh = mlp_apply(params["shared"], x_e, "silu")
        if tp_axis is not None:
            sh = _SumOver.apply(sh, mesh.get_group(tp_axis))
        y = y + sh.reshape(-1, d)
    if mean_axes:
        aux = _MeanOver.apply(aux, [mesh.get_group(a) for a in mean_axes])
    return y.reshape(b, s, d), aux
