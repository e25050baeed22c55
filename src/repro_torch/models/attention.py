"""GQA attention: projections, the full-sequence block, blocked attention
and KV-cache decode.

The full-sequence attention goes through ``kernels.ops.attention``: the
Hopper flash-attention kernel on the card, its plain version on the CPU
(where the reference calls ``blocked_attention``, ``attention.py:228``),
both inside an autograd ``Function`` whose backward recomputes through
``blocked_attention`` here, as the reference's ``custom_vjp`` does
(``repro/kernels/ops.py:41-72``).  Decode attends one token against the
cache in plain PyTorch, as the reference does (it has no decode kernel).

GQA grouping is kv-major throughout: q head h reads kv head h // g.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import is_dtensor
from ..kernels import ops
from .common import Params, apply_rope, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, d_model: int, num_heads: int,
              num_kv_heads: int, head_dim: int, qkv_bias: bool, *, lead=(),
              dtype=torch.float32) -> Params:
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, lead=lead,
                         dtype=dtype),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, lead=lead,
                         dtype=dtype),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, lead=lead,
                         dtype=dtype),
        "wo": dense_init(gen, num_heads * head_dim, d_model, lead=lead,
                         dtype=dtype),
    }
    if qkv_bias:
        for name, width in (("bq", num_heads), ("bk", num_kv_heads),
                            ("bv", num_kv_heads)):
            p[name] = torch.zeros((*lead, width * head_dim), dtype=dtype,
                                  device=gen.device)
    return p


def _project(params: Params, x: torch.Tensor, name: str, heads: int,
             head_dim: int) -> torch.Tensor:
    """x (B, S, D) @ w{name} (+ b{name}) -> (B, S, heads, head_dim)."""
    b, s, _ = x.shape
    y = x @ params["w" + name].to(x.dtype)
    if "b" + name in params:
        y = y + params["b" + name].to(x.dtype)
    return whole_heads(y, heads).reshape(b, s, heads, head_dim)


def whole_heads(y: torch.Tensor, heads: int) -> torch.Tensor:
    """Under a mesh, a projection's columns (..., heads·hd) split so that
    every rank holds whole heads: the columns stay split over the mesh
    dims (major first) whose sizes multiply into a divisor of ``heads`` and
    are gathered over the others (the reference's sanitized spec may cut a
    head, e.g. 2 KV heads on 4-way TP)."""
    if not is_dtensor(y):
        return y
    pl = whole_head_placements(y.placements, y.device_mesh, y.ndim - 1,
                               heads)
    return y if pl == list(y.placements) else y.redistribute(y.device_mesh,
                                                             pl)


def whole_head_placements(placements, mesh, dim: int, heads: int) -> list:
    """``placements`` with ``Shard(dim)`` kept on the mesh dims, in order,
    whose sizes multiply into a divisor of ``heads``, and ``Replicate()``
    on the other mesh dims that split ``dim``."""
    from torch.distributed.tensor import Replicate, Shard
    out, parts = [], 1
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            if heads % (parts * mesh.size(i)):
                p = Replicate()
            else:
                parts *= mesh.size(i)
        out.append(p)
    return out


def qkv_project(params: Params, x: torch.Tensor, num_heads: int,
                num_kv_heads: int, head_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    return (q_project(params, x, num_heads, head_dim),
            *kv_project(params, x, num_kv_heads, head_dim))


def q_project(params: Params, x: torch.Tensor, num_heads: int,
              head_dim: int) -> torch.Tensor:
    """x: (B, S, D) -> q (B,S,Hq,hd), the first part of ``qkv_project``."""
    return _project(params, x, "q", num_heads, head_dim)


def kv_project(params: Params, x: torch.Tensor, num_kv_heads: int,
               head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> k/v (B,S,Hkv,hd), the rest of ``qkv_project``."""
    return (_project(params, x, "k", num_kv_heads, head_dim),
            _project(params, x, "v", num_kv_heads, head_dim))


def out_project(params: Params, o: torch.Tensor) -> torch.Tensor:
    b, s, h, d = o.shape
    return laid_out_as(o.reshape(b, s, h * d)) @ params["wo"].to(o.dtype)


def laid_out_as(y: torch.Tensor, like: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Under a mesh, ``y`` redistributed to ``like``'s placements.  With no
    ``like`` (``y``'s own) it is the identity whose grad comes back to
    ``y``'s own layout: after whole heads are merged into columns, the ops
    that follow may return a grad split finer (over every TP dim, cutting a
    head), which DTensor's rule for the merge's backward view would take as
    it is and unflatten into the wrong local width."""
    if not is_dtensor(y):
        return y
    return y.redistribute(y.device_mesh, (y if like is None else
                                          like).placements)


# ---------------------------------------------------------------------------
# blocked attention core (the backward's recompute)
# ---------------------------------------------------------------------------

def _tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, sm_scale: float, carry):
    """One (q-block x k-block) online-softmax update.

    q: (B,G,Hkv,bq,hd)  k/v: (B,Hkv,bk,hd)  mask: (bq, bk)
    carry: (acc (B,G,Hkv,bq,hd), m (B,G,Hkv,bq), l (B,G,Hkv,bq)), float32
    (float64 for float64 inputs).  Products accumulate in the carry's
    dtype; P is rounded to v's dtype before the PV product
    (``attention.py:94``)."""
    acc, m, l = carry
    s = torch.einsum("bghqd,bhkd->bghqk", q.to(acc.dtype),
                     k.to(acc.dtype)) * sm_scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bghqk,bhkd->bghqd", p.to(v.dtype).to(acc.dtype),
                      v.to(acc.dtype))
    return acc * alpha[..., None] + pv, m_new, l_new


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """q (B,Sq,Hq,hd), k/v (B,Skv,Hkv,hd) -> (B,Sq,Hq,hd) in q's dtype: the
    reference's online-softmax blocked attention (``attention.py:79-169``),
    differentiable; float32 sums (float64 for float64 inputs).

    Each query block's key range [lo, hi) is static: keys past the block's
    last query (causal) and before its window are never visited, so masked
    tiles cost nothing.  Keys are padded to the block grid; the mask keeps
    the padding inert."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    sm_scale = 1.0 / math.sqrt(hd)
    wide = torch.promote_types(q.dtype, torch.float32)
    block_q, block_k = min(block_q, sq), min(block_k, skv)
    # (B, G, Hkv, S, hd): q head h reads kv head h // g (kv-major)
    qg = q.reshape(b, sq, hkv, g, hd).permute(0, 3, 2, 1, 4)
    pad = (-skv) % block_k
    kt = torch.nn.functional.pad(k.transpose(1, 2), (0, 0, 0, pad))
    vt = torch.nn.functional.pad(v.transpose(1, 2), (0, 0, 0, pad))
    outs = []
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        bq = q1 - q0
        hi = min(skv, q1) if causal else skv
        lo = max(0, q0 - window + 1) if window is not None else 0
        lo = (lo // block_k) * block_k
        if hi <= lo:
            outs.append(q.new_zeros((b, g, hkv, bq, hd)))
            continue
        carry = (torch.zeros((b, g, hkv, bq, hd), dtype=wide,
                             device=q.device),
                 torch.full((b, g, hkv, bq), NEG_INF, dtype=wide,
                            device=q.device),
                 torch.zeros((b, g, hkv, bq), dtype=wide, device=q.device))
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        for k0 in range(lo, hi, block_k):
            kpos = torch.arange(k0, k0 + block_k, device=q.device)[None, :]
            mask = kpos < hi                  # the ragged last block
            if causal:
                mask = mask & (qpos >= kpos)
            if window is not None:
                mask = mask & (qpos - kpos < window)
            carry = _tile(qg[:, :, :, q0:q1], kt[:, :, k0:k0 + block_k],
                          vt[:, :, k0:k0 + block_k], mask, sm_scale, carry)
        acc, _, l = carry
        outs.append((acc / l.clamp_min(1e-20)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3)
    # (b, g, hkv, sq, hd) -> (b, sq, hkv, g, hd) -> heads kv-major
    return out.permute(0, 3, 2, 1, 4).reshape(b, sq, hq, hd)


# ---------------------------------------------------------------------------
# decode and the O(S²) oracle
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One-token decode: q (B,1,Hq,hd) vs cache (B,L,Hkv,hd).

    ``cache_len``: the number of valid cache entries, the same for the whole
    batch (the new token is already written into the cache).  Products
    accumulate in float32; the probabilities are cast to the cache dtype
    before the PV product, as in the reference.  A DTensor cache (under a
    mesh) has its slots split over tp: :func:`_sharded_decode_attention`."""
    if is_dtensor(k_cache):
        return _sharded_decode_attention(q, k_cache, v_cache, cache_len)
    return _decode_local(q, k_cache, v_cache, cache_len, 0, ())


def _decode_local(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: int, first: int,
                  groups) -> torch.Tensor:
    """``decode_attention`` on a block of the cache's slots, ``first`` ..
    ``first + L - 1``, whose other blocks lie on the ranks of ``groups``:
    the softmax's max and denominator and the PV products are summed over
    them (all-reduces), so every rank ends with the whole output.  With no
    groups, the one-device softmax: exp(s - max) / sum, then p in the cache
    dtype, as ``jax.nn.softmax`` and the reference compute it."""
    b, _, hq, hd = q.shape
    lcap, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) \
        * (1.0 / math.sqrt(hd))
    valid = torch.arange(first, first + lcap, device=q.device) < cache_len
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(den, group=g)
    p = (e / den).to(v_cache.dtype).float()
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    for g in groups:
        dist.all_reduce(o, group=g)
    return o.to(q.dtype).reshape(b, 1, hq, hd)


def _sharded_decode_attention(q, k_cache, v_cache, cache_len: int):
    """Decode attention over a cache whose slots are split over the tp mesh
    dims (``launch.dryrun.state_spec``): no rank gathers the cache.  q is
    laid out with the cache's batch split and its heads whole (a gather of
    one token's heads); each rank scores its slots, and the softmax's max,
    its denominator and the PV products are reduced over the slots' split
    before p is cast to the cache dtype (``_decode_local``), so p rounds as
    the reference's does.  The output is whole on every rank of the
    split."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..parallel.sharding import shard_block
    mesh, pl = k_cache.device_mesh, list(k_cache.placements)
    dims = [i for i, p in enumerate(pl) if isinstance(p, Shard)
            and p.dim == 1]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in pl]
    block = shard_block(mesh, dims)
    groups = [mesh.get_group(i) for i in dims]

    def local(ql, kl, vl):
        return _decode_local(ql, kl, vl, cache_len, block * kl.shape[1],
                             groups)

    return local_map(local, out_placements=rows,
                     in_placements=(rows, pl, pl), device_mesh=mesh)(
        q.redistribute(mesh, rows), k_cache, v_cache)


def reference_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """O(S²)-memory oracle with a query offset (decode-style positions)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        / math.sqrt(hd)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, sq, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# full attention block (projections + rope + core)
# ---------------------------------------------------------------------------

def attention_block(params: Params, x: torch.Tensor, cfg,
                    positions: Optional[torch.Tensor] = None,
                    kv_sink: Optional[List] = None, *, causal: bool = True,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Project → rope → attention kernel → out-project (the reference's
    ``attention.py:204-232``).

    ``positions`` (1 or B, S): RoPE's positions, ``arange(S)`` when None.
    ``kv_sink``, when given, receives this layer's post-RoPE ``(k, v)``:
    one-pass prefill fills the KV cache from it.  ``kv_override``: external
    k / v (B, Skv, Hkv, hd), cross attention: only q is projected, without
    RoPE, and attends non-causally to all Skv keys."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if kv_override is not None:
        q = q_project(params, x, hq, hd)
        o = ops.attention(q, *kv_override, causal=False)
        return out_project(params, o)
    q, k, v = qkv_project(params, x, hq, hkv, hd)
    if use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_sink is not None:
        kv_sink.append((k, v))
    o = ops.attention(q, k, v, causal=causal, window=cfg.sliding_window)
    return out_project(params, o)
