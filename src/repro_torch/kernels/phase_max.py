"""CSR segment max: the Hopper kernel's wrappers and its plain version.

``csrc/phase_max.cu`` is the counterpart of the Pallas TPU kernel
``repro/kernels/phase_max.py::_row_max_kernel`` and its wrapper
``phase_worst_pallas``: ``out[i] = max(vals[ptr[i]:ptr[i+1]])``, 0 for an
empty segment, int64 in and out.  It reads the CSR directly (no dense padded
tile, no int32 narrowing).  Two routes launch it:

* :func:`phase_max_host` — the engines' route
  (``repro_torch.core.fairshare.phase_worst_loads`` on ``cuda``): numpy in,
  numpy out.  It packs ``[ptr | vals]`` into one page-locked buffer with one
  host copy, the kernel reads that buffer in place and writes its result
  into a page-locked output buffer (zero-copy: no transfer is issued), and
  one event wait ends the call.
* :func:`phase_max` — for callers whose CSR already lies on the card: CUDA
  tensors in, a CUDA tensor out, on the current stream, no wait.

Both raise on what the kernel does not take and never compute on the CPU
themselves.  ``phase_max_plain`` computes the same function in plain
PyTorch; the CPU path and the on-card comparisons use it.

``ptr`` must start at 0, end at ``len(vals)`` and not decrease.
:func:`check_csr` checks that on the host, before ``phase_max_host`` is
called, so the kernel never reads out of bounds and ``phase_max`` never
synchronises with the card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np
import torch

from . import build

launches = 0          # kernel launches since the last reset (tests, smoke)
MIN_ENTRIES = 1 << 12  # int64 entries a staging buffer holds at first


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
    if (ptr[1:] < ptr[:-1]).any():
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


def grown(capacity: int, need: int) -> int:
    """Entries a staging buffer of ``capacity`` holds after a call that
    needs ``need``: unchanged when it fits, else at least doubled (and at
    least ``MIN_ENTRIES``), so a growing caller allocates O(log n) times."""
    if need <= capacity:
        return capacity
    return max(need, 2 * capacity, MIN_ENTRIES)


class Staging:
    """The host side of one device's calls: ``packed`` holds ``[ptr |
    vals]``, ``out`` the result; both int64, reused from call to call and
    grown by :func:`grown`, never shrunk.  A call reads only the first
    ``len(ptr) + len(vals)`` entries of ``packed`` and ``nseg`` of ``out``,
    so what a larger earlier call left behind is never read.

    This base class holds plain numpy arrays (the CPU tests drive it);
    :class:`_Mapped` holds page-locked ones the kernel reads and writes."""

    def __init__(self):
        self.packed = self.out = np.empty(0, np.int64)
        self.packed_at = self.out_at = None   # device addresses (_Mapped)

    def _alloc(self, n: int):
        """A fresh int64 array of ``n`` entries and its device address."""
        return np.empty(n, np.int64), None

    def pack(self, vals: np.ndarray, ptr: np.ndarray) -> None:
        """Copy ``ptr`` then ``vals`` (int64) into ``packed`` in one host
        copy, growing ``packed`` and ``out`` first where they are short."""
        n = len(ptr) + len(vals)
        if n > len(self.packed):
            self.packed, self.packed_at = self._alloc(grown(len(self.packed),
                                                            n))
        if len(ptr) - 1 > len(self.out):
            self.out, self.out_at = self._alloc(grown(len(self.out),
                                                      len(ptr) - 1))
        np.concatenate((ptr, vals), out=self.packed[:n])

    def result(self, nseg: int) -> np.ndarray:
        """A copy of the first ``nseg`` results (the buffer is reused)."""
        return self.out[:nseg].copy()


class _Mapped(Staging):
    """Page-locked staging of one CUDA device, which the kernel reads and
    writes in place at the addresses the C library's probe reports, and the
    event each call records and waits on."""

    def __init__(self, device: int):
        super().__init__()
        self.device = device
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(device))  # creates it
        self.event.synchronize()

    def _alloc(self, n: int):
        host = torch.empty(n, dtype=torch.int64, pin_memory=True)
        at = ctypes.c_void_p()
        err = _c("phase_max_mapped_address")(host.data_ptr(), ctypes.byref(at))
        if err != 0 or not at.value:
            raise RuntimeError(
                f"phase_max: page-locked host memory is not addressable by "
                f"CUDA device {self.device} (cudaPointerGetAttributes: "
                f"cudaError_t {err}); the zero-copy route needs unified "
                f"addressing")
        return host.numpy(), at.value   # the array keeps the tensor alive


_staging: Dict[int, _Mapped] = {}
# held across a host call's pack, launch, wait, copy-out and count, so that
# threads calling at once (the scheduler service's op thread beside a
# simulation on another) never share a staging buffer mid-call
_lock = threading.Lock()
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {   # C entry -> argtypes; every entry returns a cudaError_t
    "phase_max_launch": [_P, _P, _P, _LL, _LL, _P, _I],
    "phase_max_solve": [_P, _P, _P, _LL, _LL, _P, _I, _P],
    "phase_max_mapped_address": [_P, ctypes.POINTER(_P)],
}
_entries: Dict[str, object] = {}


def _c(name: str):
    """The C entry ``name`` with its argtypes, loaded (and built) once."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(build.library("phase_max"), name)
        fn.argtypes, fn.restype = _SIGNATURES[name], ctypes.c_int
        _entries[name] = fn
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"phase_max: {what} failed with cudaError_t {err}")


def phase_max_host(vals: np.ndarray, ptr: np.ndarray,
                   device: torch.device) -> np.ndarray:
    """The engines' route: contiguous int64 numpy ``vals`` (nvals,) and a
    CSR row pointer ``ptr`` (nseg + 1,) that :func:`check_csr` has passed,
    in; int64 numpy (nseg,) out, computed by the kernel on CUDA ``device``.

    ``ptr`` and ``vals`` are packed into the device's page-locked staging
    buffer (one host copy); one C call launches the kernel on the current
    stream, reading them there and writing into the page-locked output
    buffer, records the device's event after it and waits on that event;
    the call returns a copy of the result.  Empty work returns zeros
    unlaunched.

    The staging buffers are shared by every call on the device, so a
    module lock is held from the pack to the copy of the result (and the
    count): calls from several threads at once run one after another, each
    on a staging no other call touches mid-call.  The lock costs far less
    than the call's wait."""
    global launches
    nseg = len(ptr) - 1
    if nseg == 0 or len(vals) == 0:
        return np.zeros(nseg, np.int64)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with _lock:
        st = _staging.get(index)
        if st is None:
            st = _staging[index] = _Mapped(index)
        st.pack(vals, ptr)
        stream = torch.cuda.current_stream(index).cuda_stream
        _raise_on(_c("phase_max_solve")(
            st.packed_at + 8 * len(ptr), st.packed_at, st.out_at, nseg,
            len(vals), stream, index, st.event.cuda_event),
            "kernel launch or wait")
        launches += 1
        return st.result(nseg)


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
    index = vals.device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    _raise_on(_c("phase_max_launch")(vals.data_ptr(), ptr.data_ptr(),
                                     out.data_ptr(), nseg, vals.numel(),
                                     stream, index), "kernel launch")
    with _lock:
        launches += 1
    return out
