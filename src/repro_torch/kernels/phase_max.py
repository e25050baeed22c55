"""CSR segment max: the Hopper kernel's wrapper and its plain version.

``phase_max`` launches ``csrc/phase_max.cu``, the counterpart of the Pallas
TPU kernel ``repro/kernels/phase_max.py::_row_max_kernel`` and its wrapper
``phase_worst_pallas``: ``out[i] = max(vals[ptr[i]:ptr[i+1]])``, 0 for an
empty segment, int64 in and out.  It takes CUDA tensors only, reads the CSR
directly (no dense padded tile, no int32 narrowing) and raises on what the
kernel does not take.  ``phase_max_plain`` computes the same function in
plain PyTorch; the CPU path and the on-card comparisons use it.

``ptr`` must start at 0, end at ``len(vals)`` and not decrease.
:func:`check_csr` checks that on the host, where the simulator's arrays are
uploaded (``repro_torch.core.fairshare.phase_worst_loads``), so the wrapper
itself never synchronises with the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

launches = 0          # kernel launches since the last reset (tests, smoke)


def check_csr(ptr: np.ndarray, nvals: int) -> None:
    """Raise ``ValueError`` unless ``ptr`` is a CSR row pointer over
    ``nvals`` values: 1-D, non-empty, ``ptr[0] == 0``, ``ptr[-1] == nvals``,
    monotone."""
    if ptr.ndim != 1 or len(ptr) < 1:
        raise ValueError(f"CSR pointer must be 1-D with at least one entry, "
                         f"got shape {ptr.shape}")
    if ptr[0] != 0 or ptr[-1] != nvals:
        raise ValueError(f"CSR pointer must run from 0 to len(vals)={nvals}, "
                         f"got {ptr[0]} .. {ptr[-1]}")
    if (np.diff(ptr) < 0).any():
        raise ValueError("CSR pointer must not decrease")


def phase_max_plain(vals: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """``scatter_reduce`` amax over ``repeat_interleave``d segment ids, then
    0 where a segment is empty.  int64 (nseg,) on ``vals``' device."""
    nseg = ptr.numel() - 1
    width = ptr[1:] - ptr[:-1]
    seg = torch.repeat_interleave(
        torch.arange(nseg, device=vals.device), width)
    out = torch.zeros(nseg, dtype=torch.int64, device=vals.device)
    out.scatter_reduce_(0, seg, vals.to(torch.int64), "amax",
                        include_self=False)
    return torch.where(width > 0, out, torch.zeros_like(out))


def _lib() -> ctypes.CDLL:
    lib = build.library("phase_max")
    fn = lib.phase_max_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, p]
        fn.restype = ctypes.c_int
    return lib


def phase_max(vals: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on contiguous int64 CUDA tensors ``vals``
    (nvals,) and ``ptr`` (nseg + 1,); returns int64 (nseg,) on their
    device, on the current stream.  Empty work returns zeros unlaunched."""
    global launches
    for name, t in (("vals", vals), ("ptr", ptr)):
        if not t.is_cuda or t.device != vals.device:
            raise ValueError(f"phase_max: {name} must be on vals' CUDA "
                             f"device, got {t.device}")
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"phase_max: {name} must be a contiguous 1-D "
                             f"int64 tensor, got {t.dtype} of shape "
                             f"{tuple(t.shape)}")
    if ptr.numel() < 1:
        raise ValueError("phase_max: ptr needs at least one entry")
    nseg = ptr.numel() - 1
    if nseg == 0 or vals.numel() == 0:
        return torch.zeros(nseg, dtype=torch.int64, device=vals.device)
    out = torch.empty(nseg, dtype=torch.int64, device=vals.device)
    fn = _lib().phase_max_launch
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(vals.data_ptr(), ptr.data_ptr(), out.data_ptr(), nseg,
                 vals.numel(), stream)
    if err != 0:
        raise RuntimeError(f"phase_max: kernel launch failed with "
                           f"cudaError_t {err}")
    launches += 1
    return out
