"""Flash-attention forward: the Hopper kernel's wrapper and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu``, the counterpart of
the Pallas TPU kernel ``repro/kernels/flash_attention.py::_attn_kernel`` and
its GQA wrapper ``repro/kernels/ops.py::flash_attention``.  It takes CUDA
tensors only and raises on what the kernel does not take.  The source holds
two kernels, chosen by dtype and head_dim (``check_layout`` names the one a
call launches): bf16 at head_dim 64 / 128 runs ``attn_fwd_wgmma_kernel``
(wgmma, TMA, a ring of K/V stages), bf16 at 16 / 32 / 80 / 96 / 192 and all
of float32 run ``attn_fwd_mma_kernel`` (mma.sync, or FMAs).
``flash_attention_plain`` computes the same function in plain PyTorch, with
the same ``-1e30`` masking sentinel, ``max(l, 1e-20)`` finalize and kv-major
GQA grouping; the CPU path and the on-card comparisons use it.

Both take q (B, Sq, Hq, hd) and k/v (B, Skv, Hkv, hd) with Hq a multiple of
Hkv; q head h reads kv head h // (Hq // Hkv).  As in the reference kernel,
the causal mask assumes q and k positions both start at 0, so this is the
attention of a full-sequence pass (forward, one-pass prefill), not of decode.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the last reset (tests, smoke)
last_variant = None   # the variant of the last launch (VARIANTS)
last_shape = None     # (B, Sq, Hq, Hkv, head_dim) of the last launch


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
    return o.reshape(b, sq, hq, hd).to(q.dtype)


# The kernel variants of csrc/flash_attention.cu, by the code its
# flash_attention_variant returns: float32 on FMAs and bf16 head_dim 16 / 32
# / 80 / 96 / 192 on mma.sync share attn_fwd_mma_kernel; bf16 head_dim 64 /
# 128 runs attn_fwd_wgmma_kernel (wgmma, TMA, a ring of K/V stages).
VARIANTS = ("mma_fma", "mma_sync", "wgmma_tma")
WGMMA_HEAD_DIMS = (64, 128)
_TMA_STRIDE_LIMIT = 2 ** 40


def check_layout(shapes, strides, element_size: int, bases) -> str:
    """Refuse a q/k/v layout the kernel cannot read; name the variant.

    ``shapes`` and ``strides`` are the (B, S, H, hd) shapes and element
    strides of q, k and v, ``bases`` their data addresses; ``element_size``
    is 4 (float32) or 2 (bf16).  Every variant needs a unit last stride, a
    16-byte aligned base and byte strides that are multiples of 16 (the TMA
    maps' rule, and the 16-byte loads' of the mma kernel), and a head_dim in
    ``HEAD_DIMS``; the TMA maps also need each stride in (0, 2**40) bytes.
    A dimension of size 1 is never stepped over, so its stride is free."""
    hd = shapes[0][3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if element_size == 4:
        variant = "mma_fma"
    else:
        variant = "wgmma_tma" if hd in WGMMA_HEAD_DIMS else "mma_sync"
    for name, shape, stride, base in zip("qkv", shapes, strides, bases):
        steps = [st * element_size for n, st in zip(shape[:3], stride[:3])
                 if n > 1]                   # byte strides that are walked
        if stride[3] != 1 or base % 16 or any(b % 16 for b in steps):
            raise ValueError(f"flash_attention: {name} needs a unit last "
                             f"stride, 16-byte aligned rows and base; got "
                             f"strides {tuple(stride)}, base {base:#x}")
        if variant == "wgmma_tma" and any(
                not 0 < b < _TMA_STRIDE_LIMIT for b in steps):
            raise ValueError(f"flash_attention: {name} byte strides must be "
                             f"in (0, 2**40) for a TMA map; got strides "
                             f"{tuple(stride)}")
    return variant


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> str:
    check_window(window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on q's CUDA "
                             f"device, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash_attention: q/k/v must share one dtype of "
                             f"{sorted(map(str, _DTYPE_CODE))}, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, hd), "
                             f"got shape {tuple(t.shape)}")
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


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
        for name in ("flash_attention_smem_bytes", "flash_attention_variant"):
            getattr(lib, name).argtypes = [i, i]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory of one CTA of the kernel variant."""
    return _lib().flash_attention_smem_bytes(_DTYPE_CODE[dtype], head_dim)


def built_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The variant the built library launches for (dtype, head_dim): the
    C side's own dispatch, against which ``check_layout``'s name is held."""
    return VARIANTS[_lib().flash_attention_variant(_DTYPE_CODE[dtype],
                                                   head_dim)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors; returns (B, Sq, Hq, hd)."""
    global launches, last_variant, last_shape
    build.refuse_grad("flash_attention", q, k, v)
    variant = _check(q, k, v, window)
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = _lib().flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], b, sq, skv, hq, hkv, hd, strides,
                 int(causal), window or 0, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"cudaError_t {err}")
    launches += 1
    last_variant = variant
    last_shape = (b, sq, hq, hkv, hd)
    return out
