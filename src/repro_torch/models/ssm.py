"""Attention-free sequence mixers: Mamba2 (SSD) and RWKV6 time-mix /
channel-mix.

Both are chunked linear recurrences,

    S_t = diag(d_t) · S_{t-1} + k_t vᵀ_t          (state: (K, V) per head)
    o_t = qᵀ_t · S_t  (+ the bonus diagonal)

clamped at LOG_DECAY_MIN and centred per chunk as in the reference
(``repro/models/ssm.py``).  The full-sequence pass goes through
``kernels.ops.rwkv6_mix_state``: on the card the fused Hopper kernel, which
reads q, k, v and the log decay in place through their strides and does the
decay precompute and the bonus itself, its plain version on the CPU (where
the reference scans the jnp chunked form, ``ssm.py:204,271``), inside an
autograd ``Function`` whose backward recomputes through
``chunked_linear_attention_scan``, the reference's differentiable chunk
scan written as a loop over chunks.  RWKV6 runs the exclusive mask with a
bonus on the model's bf16 ``split_heads`` views; Mamba2 the inclusive mask
with no bonus, on float32 operands (see :func:`mamba2_apply`).  Decode
steps one token in plain PyTorch, as the reference does (it has no decode
kernel).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..kernels import ops
from ..kernels.rwkv6 import LOG_DECAY_MIN
from .attention import laid_out_as, whole_head_placements, whole_heads
from .common import Params, dense_init, norm_apply, norm_init


# ---------------------------------------------------------------------------
# chunked linear recurrence with per-channel decay
# ---------------------------------------------------------------------------

def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, log_decay: torch.Tensor,
                             bonus: Optional[torch.Tensor] = None,
                             chunk: int = 16,
                             initial_state: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k,v: (B,H,T,K/V); log_decay: (B,H,T,K) (<=0); bonus u: (H,K) or None.

    Returns (out (B,H,T,V) in q's dtype, final_state (B,H,K,V) float32).
    RWKV6 convention: with a bonus, o_t reads S_{t-1} and the current token
    enters through u ⊙ k_t."""
    return ops.rwkv6_mix_state(q, k, v, log_decay, bonus=bonus, chunk=chunk,
                               initial_state=initial_state)


def chunked_linear_attention_scan(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, log_decay: torch.Tensor,
                                  bonus: Optional[torch.Tensor] = None,
                                  chunk: int = 16,
                                  initial_state: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``chunked_linear_attention`` (``ssm.py:36-100``) as a
    differentiable loop over chunks: the clamp at LOG_DECAY_MIN, the
    in-chunk cumsum L, the chunk total Lc, the centring, the four
    exponentials, the strict (bonus) or inclusive mask and, with a bonus,
    the diagonal Σ_k q·u·k times v.  Same shapes and returns as
    :func:`chunked_linear_attention` (float64 inputs keep float64); the
    recurrence's backward recomputes through it."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} must be a multiple of chunk={chunk}")
    nc = t // chunk
    wide = torch.promote_types(q.dtype, torch.float32)
    ld = log_decay.to(wide).clamp(LOG_DECAY_MIN, 0.0).reshape(b, h, nc, chunk,
                                                             dk)
    qf = q.to(wide).reshape(b, h, nc, chunk, dk)
    kf = k.to(wide).reshape(b, h, nc, chunk, dk)
    vf = v.to(wide).reshape(b, h, nc, chunk, dv)
    L = ld.cumsum(dim=3)                              # (b,h,nc,C,K), <= 0
    Lc = L[:, :, :, -1:, :]                           # chunk total
    r = torch.arange(chunk, device=q.device)
    if bonus is None:      # inclusive: o_t reads S_t
        L_read, mask = L, r[:, None] >= r[None, :]
    else:                  # RWKV: o_t reads S_{t-1}, plus u ⊙ k_t
        L_read, mask = L - ld, r[:, None] > r[None, :]
    center = 0.5 * (L_read.amax(dim=3, keepdim=True)
                    + L.amin(dim=3, keepdim=True))
    q_in = qf * torch.exp(L_read)
    k_intra = kf * torch.exp(center - L)
    q_intra = qf * torch.exp(L_read - center)
    k_out = kf * torch.exp(Lc - L)
    decay = torch.exp(Lc).transpose(-1, -2)           # (b,h,nc,K,1)
    S = (initial_state.to(wide) if initial_state is not None else
         torch.zeros((b, h, dk, dv), dtype=wide, device=q.device))
    outs = []
    for c in range(nc):
        scores = torch.where(mask, q_intra[:, :, c]
                             @ k_intra[:, :, c].transpose(-1, -2), 0.0)
        outs.append(q_in[:, :, c] @ S + scores @ vf[:, :, c])
        S = decay[:, :, c] * S + k_out[:, :, c].transpose(-1, -2) @ vf[:, :, c]
    out = torch.stack(outs, dim=2).reshape(b, h, t, dv)
    if bonus is not None:
        diag = torch.einsum("bhtk,hk,bhtk->bht", q.to(wide), bonus.to(wide),
                            k.to(wide))
        out = out + diag[..., None] * v.to(wide)
    return out.to(q.dtype), S


def linear_attention_step(q, k, v, log_decay, S,
                          bonus: Optional[torch.Tensor] = None):
    """Single-token decode step.  q,k,v: (B,H,K/V); S: (B,H,K,V) float32.
    Under a mesh (DTensors) each rank steps its own batch rows and heads
    (:func:`_sharded_step`)."""
    if is_dtensor(v):
        return _sharded_step(q, k, v, log_decay, S, bonus)
    ld = log_decay.float().clamp(LOG_DECAY_MIN, 0.0)
    qf, kf, vf = q.float(), k.float(), v.float()
    S_new = torch.exp(ld)[..., None] * S + kf[..., None] * vf[..., None, :]
    if bonus is not None:
        o = torch.einsum("bhk,bhkv->bhv", qf, S) \
            + torch.einsum("bhk,hk,bhk->bh", qf, bonus.float(),
                           kf)[..., None] * vf
    else:
        o = torch.einsum("bhk,bhkv->bhv", qf, S_new)
    return o.to(q.dtype), S_new


def _sharded_step(q, k, v, log_decay, S, bonus):
    """``linear_attention_step`` on DTensors: the step is independent per
    (batch row, head), so every operand is laid out as v's batch and heads
    split (Mamba2's q, k and log decay are whole over the heads: each rank
    slices its own, no collective) and each rank steps its block through
    ``local_map``, as on one device.  DTensor's own rules would flatten the
    split batch and head dims in the einsums, which torch 2.11 refuses."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = v.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
          for p in v.placements]
    heads = [Shard(0) if isinstance(p, Shard) and p.dim == 1 else Replicate()
             for p in pl]
    ins = [t.redistribute(mesh, pl) for t in (q, k, v, log_decay, S)]
    if bonus is not None:
        bonus = bonus.redistribute(mesh, heads)
    return local_map(linear_attention_step, out_placements=(pl, pl),
                     in_placements=(pl,) * 5 + (None if bonus is None
                                                else heads,),
                     device_mesh=mesh)(*ins, bonus)


def linear_attention_reference(q, k, v, log_decay, bonus=None,
                               initial_state=None):
    """Sequential oracle: one :func:`linear_attention_step` per token."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    S = (initial_state.float() if initial_state is not None else
         torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device))
    outs = []
    for i in range(t):
        o, S = linear_attention_step(q[:, :, i], k[:, :, i], v[:, :, i],
                                     log_decay[:, :, i], S, bonus=bonus)
        outs.append(o)
    return torch.stack(outs, dim=2).to(q.dtype), S


# ---------------------------------------------------------------------------
# Mamba2 block (SSD formulation)
# ---------------------------------------------------------------------------

def mamba2_init(gen: torch.Generator, d_model: int, d_state: int, heads: int,
                expand: int, *, lead=(), dtype=torch.float32) -> Params:
    """The reference's ``mamba2_init`` (``ssm.py:144-159``) with a ``lead``
    axis: ``a_log``, ``d_skip``, ``dt_bias`` and the norm stay float32
    whatever ``dtype`` is, as there."""
    d_inner = d_model * expand
    dev = gen.device

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, lead=lead, dtype=dtype)
    conv = torch.randn((*lead, 4, d_inner), generator=gen, device=dev)
    return {
        "w_in": dense(d_model, 2 * d_inner),                   # x, z gate
        "w_bc": dense(d_model, 2 * d_state),                   # B, C proj
        "w_dt": dense(d_model, heads),
        "a_log": torch.zeros((*lead, heads), device=dev),      # A = -exp(a)
        "d_skip": torch.ones((*lead, heads), device=dev),
        "dt_bias": torch.zeros((*lead, heads), device=dev),
        "conv": conv.mul_(0.1).to(dtype),
        "w_out": dense(d_inner, d_model),
        "norm": norm_init("rmsnorm", d_inner, device=dev, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, kernel 4.  x: (B,T,D), w: (4,D); state
    (B,3,D): the trailing context decode carries (zeros when None; under
    a mesh laid out as x before the concatenation).  Returns (y in x's
    dtype, the new trailing context)."""
    b, t, d = x.shape
    kw = w.shape[0]
    if state is None:
        state = torch.zeros_like(x[:, :1]).expand(b, kw - 1, d)
    else:
        state = laid_out_as(state, x)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    wx = _columns_as(w, x).to(x.dtype)
    y = xp[:, :t] * wx[0]
    for i in range(1, kw):
        y = y + xp[:, i:i + t] * wx[i]
    return y, xp[:, -(kw - 1):]


def _columns_as(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Under a mesh, a per-channel weight (..., D) laid out with its columns
    split as ``x``'s last dim is and replicated otherwise, so that ``x * w``
    keeps ``x``'s layout: where the TP split does not divide the heads,
    ``x``'s columns are whole and a TP-split weight would split them again,
    cutting heads."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    pl = [Shard(w.ndim - 1) if isinstance(p, Shard) and p.dim == last
          else Replicate() for p in x.placements]
    return w.redistribute(w.device_mesh, pl)


def mamba2_apply(params: Params, x: torch.Tensor, heads: int, d_state: int,
                 expand: int, chunk: int = 16, state: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,T,D).  state (decode): {"ssm": (B,H,K,V), "conv": (B,3,Din)}.
    Returns (y, {"ssm": the final S (B,H,K,V) float32, "conv": the conv's
    trailing context}); the one-pass prefill hands both to decode.

    As in the reference (``ssm.py:177-222``) q = C and v = the conv output
    are in x's dtype while k = B·dt and the log decay dt·A are float32, and
    the recurrence computes in float32 and returns q's dtype.  The kernel
    takes one dtype for all four operands, so the full-sequence pass hands
    it float32 ones and casts its output to x's dtype.  C and B are shared
    by the heads: q is C broadcast over H (a zero head stride, read in
    place), k the product B·dt (B,H,T,K).  The log decay is a scalar per
    (b, h, t) broadcast over K: a zero inner stride, which the kernel
    refuses, so it alone is made contiguous (B,H,T,K).  v is the float32
    copy of the conv output's (B,H,T,hd) view, in its strides."""
    b, t, d = x.shape
    d_inner = d * expand
    hd = d_inner // heads
    xi, z = _in_project(x, params["w_in"].to(x.dtype), heads)
    xi, conv_state = _causal_conv(xi, params["conv"],
                                  None if state is None else state["conv"])
    xi = F.silu(xi)
    # products with weights TP does not split, laid out as x is (batch rows
    # split, the rest whole); dt is read transposed below, and under a mesh
    # its grad reaches the product's DTensor view as it is, which needs it
    # contiguous
    B_, C_ = laid_out_as(x @ params["w_bc"].to(x.dtype), x).chunk(2, dim=-1)
    dt = F.softplus(ops.contiguous_grad(laid_out_as(
        x @ params["w_dt"].to(x.dtype), x)).float()
        + params["dt_bias"].float())                              # (B,T,H)
    a = -torch.exp(params["a_log"].float())                      # (H,) < 0
    ld = (dt * a).transpose(1, 2)[..., None].expand(b, heads, t, d_state)
    vals = xi.reshape(b, t, heads, hd).transpose(1, 2)           # (B,H,T,hd)
    kq = B_.float()[:, None] * dt.transpose(1, 2)[..., None]     # (B,H,T,K)

    def over_heads(y):
        return y[:, None].expand(b, heads, t, d_state)
    if state is None:
        out, S = ops.rwkv6_mix_state(over_heads(C_.float()), kq,
                                     vals.float(), ld.contiguous(),
                                     chunk=chunk)
        out = out.to(x.dtype)
    else:
        o, S = linear_attention_step(over_heads(C_)[:, :, 0], kq[:, :, 0],
                                     vals[:, :, 0], ld[:, :, 0],
                                     state["ssm"])
        out = o[:, :, None]
    out = out + params["d_skip"].to(out.dtype)[:, None, None] * vals
    y = out.transpose(1, 2).reshape(b, t, d_inner)
    y = laid_out_as(y)
    y = norm_apply("rmsnorm", params["norm"], y) * F.silu(z)
    return y @ params["w_out"].to(x.dtype), {"ssm": S, "conv": conv_state}


def _in_project(x: torch.Tensor, w_in: torch.Tensor, heads: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, z) = ``x @ w_in`` split in two along its columns.  Under a mesh
    ``w_in``'s 2·d_inner columns are split over TP as one dim (the
    reference's spec), so a rank's block holds x's or z's columns, not
    some of each: the product is laid out as ``x`` is (its batch rows
    split, the columns whole), split in two, and each half laid out over
    the TP dims that split the heads (a local slice), so the conv, the
    recurrence and the gate run on each rank's rows and whole heads."""
    xz = x @ w_in
    if not is_dtensor(xz):
        return xz.chunk(2, dim=-1)
    from torch.distributed.tensor import Shard
    mesh, last = xz.device_mesh, xz.ndim - 1
    rows = list(x.placements)
    split = whole_head_placements(
        [Shard(last) if isinstance(p, Shard) and p.dim == last else r
         for p, r in zip(xz.placements, rows)], mesh, last, heads)
    return tuple(h.redistribute(mesh, split) for h in
                 xz.redistribute(mesh, rows).chunk(2, dim=-1))


# ---------------------------------------------------------------------------
# RWKV6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------

def _sum_partials(y: torch.Tensor) -> torch.Tensor:
    """Under a mesh, ``y`` with its partial sums reduced.  A product whose
    contracted dim FSDP splits over "data" (``w_decay_b``'s 64 rows) comes
    back a partial sum over "data" when the rows it multiplies are whole
    there (a batch of one, which does not split over dp), and PyTorch
    2.11's DTensor cannot add such a sum to a vector split over "data"
    (``decay_base``)."""
    if not is_dtensor(y) or not any(p.is_partial() for p in y.placements):
        return y
    from torch.distributed.tensor import Replicate
    return y.redistribute(y.device_mesh, [
        Replicate() if p.is_partial() else p for p in y.placements])


def rwkv6_init(gen: torch.Generator, d_model: int, head_dim: int, *,
               lead=(), dtype=torch.float32) -> Params:
    heads = d_model // head_dim
    dev = gen.device

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, lead=lead, dtype=dtype)
    return {
        "w_r": dense(d_model, d_model), "w_k": dense(d_model, d_model),
        "w_v": dense(d_model, d_model), "w_g": dense(d_model, d_model),
        "w_o": dense(d_model, d_model),
        # data-dependent decay: low-rank path w = exp(-exp(base + x@A@B))
        "w_decay_a": dense(d_model, 64), "w_decay_b": dense(64, d_model),
        "decay_base": torch.full((*lead, d_model), -0.5, device=dev),
        "bonus_u": torch.randn((*lead, heads, head_dim), generator=gen,
                               device=dev) * 0.1,
        "mix_x": torch.full((*lead, 5, d_model), 0.5, device=dev),
        "ln_x": norm_init("layernorm", d_model, device=dev, lead=lead),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """x shifted one step later: the previous token's vector at each
    position, zeros (or the decode state's ``last``) at the first."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv6_time_mix(params: Params, x: torch.Tensor, head_dim: int,
                   chunk: int = 16, state: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,T,D).  state (decode): {"S": (B,H,K,V), "last": (B,D)}.

    ``decay_base`` and ``bonus_u`` are read in float32 and the log decay is
    rounded to x's dtype before the clamp, as in the reference
    (``ssm.py:264,269``)."""
    b, t, d = x.shape
    heads = d // head_dim
    last = _token_shift(x, None if state is None else state["last"])
    mix = params["mix_x"].to(x.dtype)
    xs = [x + (last - x) * mix[i] for i in range(5)]  # r,k,v,g,w token-shift
    r = xs[0] @ params["w_r"].to(x.dtype)
    k = xs[1] @ params["w_k"].to(x.dtype)
    v = xs[2] @ params["w_v"].to(x.dtype)
    g = F.silu(xs[3] @ params["w_g"].to(x.dtype))
    # the low-rank decay path, each product laid out as its forward is:
    # their grads would otherwise reach the weight-grad products of
    # w_decay_a and w_decay_b split over the tokens (a strided split of the
    # flattened batch and sequence), which DTensor cannot lay out
    low = laid_out_as(torch.tanh(xs[4] @ params["w_decay_a"].to(x.dtype)))
    dec = _sum_partials(laid_out_as(
        low @ params["w_decay_b"].to(x.dtype))).float()
    log_decay = -torch.exp(params["decay_base"] + dec)        # (B,T,D) < 0

    def split_heads(y):
        # under a mesh each rank holds whole heads of the TP-split columns
        return whole_heads(y, heads).reshape(b, t, heads,
                                             head_dim).transpose(1, 2)

    rq, kk, vv, ld = map(split_heads, (r, k, v, log_decay.to(x.dtype)))
    if state is None:
        out, S = chunked_linear_attention(rq, kk, vv, ld, chunk=chunk,
                                          bonus=params["bonus_u"])
    else:
        o, S = linear_attention_step(rq[:, :, 0], kk[:, :, 0], vv[:, :, 0],
                                     ld[:, :, 0], state["S"],
                                     bonus=params["bonus_u"])
        out = o[:, :, None]
    y = out.transpose(1, 2).reshape(b, t, d)
    y = laid_out_as(y)
    y = norm_apply("layernorm", params["ln_x"], y) * g
    # the reference's einsum("btd,de->btd", y, w_o) sums w_o over e: each
    # channel is scaled by a row sum of w_o; it is not a matrix product
    y = y * params["w_o"].to(x.dtype).sum(dim=-1)
    return y, {"S": S, "last": x[:, -1]}


def rwkv6_channel_mix_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                           lead=(), dtype=torch.float32) -> Params:
    return {
        "w_k": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
        "w_v": dense_init(gen, d_ff, d_model, lead=lead, dtype=dtype),
        "mix": torch.full((*lead, d_model), 0.5, device=gen.device),
    }


def rwkv6_channel_mix(params: Params, x: torch.Tensor,
                      state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,D); state (decode): the previous token's x (B,D).  Returns
    (y, x[:, -1])."""
    last = _token_shift(x, state)
    xk = x + (last - x) * params["mix"].to(x.dtype)
    h = F.relu(xk @ params["w_k"].to(x.dtype)).square()
    return h @ params["w_v"].to(x.dtype), x[:, -1]
