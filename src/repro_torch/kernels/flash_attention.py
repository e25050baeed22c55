"""Flash-attention forward: the Hopper kernel's wrapper and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu``, the counterpart of
the Pallas TPU kernel ``repro/kernels/flash_attention.py::_attn_kernel`` and
its GQA wrapper ``repro/kernels/ops.py::flash_attention``.  It takes CUDA
tensors only, at any head_dim from 1 to ``MAX_HEAD_DIM`` in float32, bf16 or
float16, and raises on what the kernel does not take.  Its two libraries
(``csrc/flash_attention.cu`` and ``csrc/flash_attention_cols.cu``, which
share ``csrc/flash_attention.cuh``) hold four kernels, chosen by dtype,
head_dim and the rows' alignment (``check_layout`` names the variant a
call launches, ``VARIANTS``):

* 16-bit head dims that are a multiple of 8 up to 192 (16 and 32 aside)
  on 16-byte rows: ``attn_fwd_wgmma_kernel`` (wgmma, TMA, a ring of K/V
  stages) at the least of its instance widths ``WGMMA_HEAD_DIMS`` that
  holds them ("wgmma_tma");
* 16-bit 16 / 32 and float32 at ``MMA_HEAD_DIMS`` on 16-byte rows:
  ``attn_fwd_mma_kernel`` (mma.sync, or FMAs: "mma_sync", "mma_fma");
* every other 16-bit call: ``attn_fwd_wgmma_cols_kernel``, the wgmma
  kernel's consumers over column blocks of O (``plan`` makes its launch
  plan), fed by TMA for head dims that are a multiple of 8 above 192 on
  16-byte rows ("wgmma_cols") and by cp.async at the rows' own alignment
  for the rest ("wgmma_cp_async");
* every other float32 call: ``attn_fwd_split_kernel`` (O's columns split
  over CTAs, element loads, FMAs: "mma_split").

``flash_attention_plain`` computes the
same function in plain PyTorch, with the same ``-1e30`` masking sentinel,
``max(l, 1e-20)`` finalize and kv-major GQA grouping; the CPU path and the
on-card comparisons use it.

Both take q (B, Sq, Hq, hd) and k/v (B, Skv, Hkv, hd) with Hq a multiple of
Hkv; q head h reads kv head h // (Hq // Hkv).  As in the reference kernel,
the causal mask assumes q and k positions both start at 0, so this is the
attention of a full-sequence pass (forward, one-pass prefill), not of decode.

The model path reaches both through one registered op,
``torch.ops.repro_torch.flash_attention_fwd`` (``kernels/ops.py``), whose
FLOP formula is :func:`flops`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches = 0          # kernel launches since the last reset (tests, smoke)
last_variant = None   # the variant of the last launch (VARIANTS)
last_shape = None     # (B, Sq, Hq, Hkv, head_dim) of the last launch
last_plan = None      # the column-block kernel's plan at the last launch


def check_window(window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Dense masked softmax in float32 (float64 for float64 inputs, which
    only the CPU takes); output in q's dtype."""
    check_window(window)
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    wide = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(wide).reshape(b, sq, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(wide)) * (1.0 / math.sqrt(hd))
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).clamp_min(1e-20)                        # (b, h, g, q)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(wide))
    o = o / l.permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, sq, hq, hd).to(q.dtype).contiguous()


def live_pairs(sq: int, skv: int, causal: bool,
               window: Optional[int]) -> int:
    """The (q, k) pairs the masks leave: q row i sees keys [max(0, i -
    window + 1), min(Skv, i + 1)) causal, [.., Skv) otherwise."""
    rows = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, rows + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, rows - window + 1) if window else 0
    return int(np.maximum(hi - lo, 0).sum())


def flops(b: int, sq: int, skv: int, hq: int, hd: int, causal: bool,
          window: Optional[int]) -> int:
    """The work of one call, as ``PERF.md`` §2 prices the kernel's bound:
    4·B·Hq·hd per live (q, k) pair (QKᵀ and PV, a multiply and an add
    each)."""
    return 4 * b * hq * hd * live_pairs(sq, skv, causal, window)


# The kernel variants of csrc/flash_attention.cu, by the code its
# flash_attention_variant returns: float32 on FMAs and 16-bit head_dim 16 /
# 32 on mma.sync share attn_fwd_mma_kernel; 16-bit head dims that are a
# multiple of 8 up to 192 run attn_fwd_wgmma_kernel (wgmma, TMA, a ring of
# K/V stages) at its instance widths; attn_fwd_split_kernel takes the rest of
# float32; attn_fwd_wgmma_cols_kernel the rest of 16-bit, by TMA above 192
# and by cp.async where TMA cannot map the rows.
VARIANTS = ("mma_fma", "mma_sync", "wgmma_tma", "mma_split", "wgmma_cols",
            "wgmma_cp_async")
COLS_VARIANTS = ("wgmma_cols", "wgmma_cp_async")
MMA_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192)   # float32 instances
WGMMA_HEAD_DIMS = (64, 80, 96, 128, 192)         # wgmma instance widths
SPLIT_COLUMNS = 128    # O columns a CTA of the split kernel owns
# the column-block kernel's instances by route: the 64-column boxes of a Q
# or K row each compiles (S = Q K^T runs four k16 steps a box, the columns
# past hd zero), as csrc/flash_attention.cu::cols_instance lists them
COLS_BOXES = {"wgmma_cols": (4, 5, 8), "wgmma_cp_async": (2, 3, 4, 5, 8)}
COLS_MAX_WIDTH = 192   # O above 192 columns does not fit a consumer's registers
MAX_STAGES = 4
MAX_SMEM = 232448      # dynamic shared memory a CTA may take on the H100
_TMA_STRIDE_LIMIT = 2 ** 40


def variant_of(element_size: int, hd: int, aligned: bool) -> str:
    """The variant a (dtype, head_dim) takes on rows that are 16-byte
    aligned or not, as ``csrc/flash_attention.cu::variant`` chooses it."""
    if element_size == 4:
        return "mma_fma" if aligned and hd in MMA_HEAD_DIMS else "mma_split"
    if not aligned or hd % 8:
        return "wgmma_cp_async"
    if hd in (16, 32):
        return "mma_sync"
    return "wgmma_tma" if hd <= 192 else "wgmma_cols"


def _walked(shape, stride, element_size):
    """The byte strides of the (B, S, H) dimensions that are stepped over (a
    dimension of size 1 never is, so its stride is free)."""
    return [st * element_size for n, st in zip(shape[:3], stride[:3]) if n > 1]


def row_align(shapes, strides, element_size: int, bases) -> int:
    """The widest power of two up to 16 bytes on which every walked (b, s,
    h) row of q, k and v starts (its base and each walked byte stride a
    multiple of it), as ``csrc/flash_attention.cu::row_align`` finds it."""
    bits = 16
    for shape, stride, base in zip(shapes, strides, bases):
        for x in [base, *_walked(shape, stride, element_size)]:
            bits |= x
    return bits & -bits


def check_layout(shapes, strides, element_size: int, bases) -> str:
    """Refuse a q/k/v layout the kernel cannot read; name the variant.

    ``shapes`` and ``strides`` are the (B, S, H, hd) shapes and element
    strides of q, k and v, ``bases`` their data addresses; ``element_size``
    is 4 (float32) or 2 (bf16, float16).  Every variant needs a unit last
    stride and a head_dim in 1..``MAX_HEAD_DIM``.  Rows not 16-byte aligned
    (a base or a walked byte stride off 16) go to the variants whose loads
    are narrower: float32 to the split kernel, 16-bit to the column-block
    kernel's cp.async route.  The TMA variants ("wgmma_tma", "wgmma_cols")
    need each walked stride in (0, 2**40) bytes, and raise otherwise."""
    hd = shapes[0][3]
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"1..{MAX_HEAD_DIM}")
    for name, stride in zip("qkv", strides):
        if stride[3] != 1:
            raise ValueError(f"flash_attention: {name} needs a unit last "
                             f"stride; got strides {tuple(stride)}")
    aligned = row_align(shapes, strides, element_size, bases) == 16
    variant = variant_of(element_size, hd, aligned)
    if variant in ("wgmma_tma", "wgmma_cols"):
        for name, shape, stride in zip("qkv", shapes, strides):
            if any(not 0 < b < _TMA_STRIDE_LIMIT
                   for b in _walked(shape, stride, element_size)):
                raise ValueError(f"flash_attention: {name} byte strides must "
                                 f"be in (0, 2**40) for a TMA map; got "
                                 f"strides {tuple(stride)}")
    return variant


def cols_instance(boxes: int):
    """(O columns a CTA, keys a K/V tile) of the column-block instance of
    ``boxes`` boxes, as its ``wg::ColsLayout`` fixes them (the library takes
    them from the boxes; this mirror is what the CPU tests pin and the plan
    reports): 128 columns up to
    hd 128 and 256 (two blocks), else 192; 32-key tiles from 5 boxes (above
    5 two ring stages of 64-key tiles do not fit beside Q; at 5, bf16's
    wgmmas spill and serialise at 64)."""
    return (128 if boxes <= 2 or boxes == 4 else 192), (32 if boxes >= 5
                                                        else 64)


def cols_smem_bytes(boxes: int, width: int, bk: int, stages: int) -> int:
    """Dynamic shared memory of one CTA of the column-block kernel, as its
    ``wg::ColsLayout`` lays it out: 1 KB to align the 128-byte swizzle, Q
    (``boxes`` boxes of 128 rows x 64 16-bit columns), per ring stage a K
    tile (the same boxes of ``bk`` rows) and a V tile (``width`` / 64
    boxes: the block's columns), and the mbarriers (Q, and full K, full V,
    empty per stage)."""
    return (1024 + boxes * 128 * 128
            + stages * (boxes + width // 64) * bk * 128 + 8 * (1 + 3 * stages))


def plan(hd: int, align: int = 0) -> dict:
    """The launch plan of ``attn_fwd_wgmma_cols_kernel`` at a 16-bit
    head_dim, by TMA (``align`` 0) or by cp.async copies of ``align`` bytes
    (the rows' alignment: 16, 8, 4 or 2): the route's instance of the
    fewest boxes that hold hd (``COLS_BOXES``), whose width splits O into
    the fewest column blocks of at most ``COLS_MAX_WIDTH`` columns (one CTA
    each, S = Q K^T recomputed per block; a last block may be partial: its
    V columns past hd are zero and its O columns past hd never stored), 128
    q rows a CTA, and the most ring stages (up to ``MAX_STAGES``) that fit
    ``MAX_SMEM``.  "blocks" lists each block's (first column, columns below
    hd)."""
    route = "wgmma_cols" if align == 0 else "wgmma_cp_async"
    if not 1 <= hd <= MAX_HEAD_DIM or align not in (0, 2, 4, 8, 16) or (
            align == 0 and hd <= 192):
        raise ValueError(f"flash_attention: no column-block plan at head_dim "
                         f"{hd}, {align}-byte copies")
    boxes = min(b for b in COLS_BOXES[route] if 64 * b >= hd)
    width, bk = cols_instance(boxes)
    for stages in range(MAX_STAGES, 1, -1):
        smem = cols_smem_bytes(boxes, width, bk, stages)
        if smem <= MAX_SMEM:
            return {"boxes": boxes, "width": width, "bk": bk,
                    "stages": stages, "bq": 128, "align": align,
                    "smem": smem, "blocks": [(c, min(width, hd - c))
                                             for c in range(0, hd, width)]}
    raise ValueError(f"flash_attention: no column-block plan fits "
                     f"{MAX_SMEM} bytes at head_dim {hd}")


def split_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one CTA of the (float32) split kernel, as
    its ``split::Plan`` lays it out: Q (64 rows of hd padded to 64), a 64 x
    64 K chunk, 128 V columns of a 64-key tile and the warps' P rows (4 x
    16 x 68), each row padded by 16 bytes."""
    qstr = -(-hd // 64) * 64 + 4
    return 4 * (64 * qstr + 64 * 68 + 64 * (SPLIT_COLUMNS + 4) + 4 * 16 * 68)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> str:
    check_window(window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash_attention: q/k/v must share one dtype of "
                             f"{sorted(map(str, _DTYPE_CODE))}, got {t.dtype}"
                             f" (no tensor core computes float64 attention)")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, hd), "
                             f"got shape {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on q's CUDA "
                             f"device, got {t.device}")
    b, _, hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[2]}")
    return check_layout([t.shape for t in (q, k, v)],
                        [t.stride() for t in (q, k, v)], q.element_size(),
                        [t.data_ptr() for t in (q, k, v)])


_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


def _lib() -> ctypes.CDLL:
    """``csrc/flash_attention.cu``'s library: variants 0 to 3, and the
    variant each call takes."""
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _STRIDES,
                       _I, _I, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        for name in ("flash_attention_smem_bytes", "flash_attention_variant"):
            getattr(lib, name).argtypes = [_I, _I, _I]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _cols_lib() -> ctypes.CDLL:
    """``csrc/flash_attention_cols.cu``'s library: the column-block kernel
    (variants 4 and 5) in bf16 and float16, built beside the rest."""
    lib = build.library("flash_attention_cols")
    fn = lib.flash_attention_cols_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _STRIDES,
                       _I, _I, ctypes.c_float, ctypes.POINTER(ctypes.c_int),
                       _P]
        fn.restype = ctypes.c_int
        lib.flash_attention_cols_smem.argtypes = [_I] * 4
        lib.flash_attention_cols_smem.restype = ctypes.c_int
    return lib


def smem_bytes(dtype: torch.dtype, head_dim: int,
               aligned: bool = True) -> int:
    """Dynamic shared memory of one CTA of the variant that takes (dtype,
    head_dim) on rows 16-byte aligned or not, as the library counts it (the
    column-block kernel's at ``plan``'s boxes and stages, the cp.async
    route's at 2-byte copies)."""
    code = _lib().flash_attention_variant(_DTYPE_CODE[dtype], head_dim,
                                          int(aligned))
    if code >= 0 and VARIANTS[code] in COLS_VARIANTS:
        cp = VARIANTS[code] == "wgmma_cp_async"
        pl = plan(head_dim, 2 if cp else 0)
        return _cols_lib().flash_attention_cols_smem(
            head_dim, pl["boxes"], pl["stages"], int(cp))
    return _lib().flash_attention_smem_bytes(_DTYPE_CODE[dtype], head_dim,
                                             int(aligned))


def built_variant(dtype: torch.dtype, head_dim: int,
                  aligned: bool = True) -> str:
    """The variant the built library launches for (dtype, head_dim, rows
    16-byte aligned): the C side's own dispatch, against which
    ``check_layout``'s name is held."""
    return VARIANTS[_lib().flash_attention_variant(_DTYPE_CODE[dtype],
                                                   head_dim, int(aligned))]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors; returns (B, Sq, Hq, hd)."""
    global launches, last_variant, last_shape, last_plan
    build.refuse_grad("flash_attention", q, k, v)
    variant = _check(q, k, v, window)
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    pl = None
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    args = (b, sq, skv, hq, hkv, hd, strides, int(causal), window or 0,
            1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant in COLS_VARIANTS:
            align = 0 if variant == "wgmma_cols" else row_align(
                [t.shape for t in (q, k, v)], [t.stride() for t in (q, k, v)],
                q.element_size(), ptrs[:3])
            pl = plan(hd, align)
            plan_arg = (ctypes.c_int * 3)(pl["boxes"], pl["stages"], align)
            err = _cols_lib().flash_attention_cols_fwd(
                *ptrs, _DTYPE_CODE[q.dtype], *args, plan_arg, stream)
        else:
            err = _lib().flash_attention_fwd(*ptrs, _DTYPE_CODE[q.dtype],
                                             *args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"cudaError_t {err}")
    launches += 1
    last_variant = variant
    last_shape = (b, sq, hq, hkv, hd)
    last_plan = pl
    return out

