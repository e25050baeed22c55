"""RWKV6 / Mamba2 chunked recurrence: the Hopper kernel's wrapper and its
plain version.

``rwkv6_chunked`` launches ``csrc/rwkv6.cu``, the counterpart of the Pallas
TPU kernel ``repro/kernels/rwkv6.py::_rwkv_kernel`` (``rwkv6_chunked_fwd``).
Both take the decay-scaled float32 inputs that ``ops.rwkv6_inputs``
precomputes: q_in, q_intra, k_intra, k_out (BH, T, K), v (BH, T, V) and the
per-chunk total decay (BH, T/C, K), and return o (BH, T, V) of

    o_chunk = q_in · S + mask(q_intra · k_intraᵀ) · v
    S      ← diag(decay_chunk) · S + k_outᵀ · v

with the strict lower-triangular mask when ``exclusive`` (RWKV6, whose bonus
diagonal the caller adds) and the inclusive one otherwise.  Unlike the TPU
kernel, both also take an initial state (zeros when None) and return the
final S (BH, K, V), which the one-pass prefill hands to decode.
``rwkv6_chunked`` takes CUDA tensors only and raises on what the kernel does
not take; ``rwkv6_chunked_plain`` computes the same function with batched
products over the chunk loop, for the CPU path and the on-card comparisons.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

LOG_DECAY_MIN = -4.0  # per-step clamp; e^-4 ≈ 0.018, far below trained decays
KV_DIMS = (8, 16, 32, 64, 128)
MAX_CHUNK = 64

launches = 0          # kernel launches since the last reset (tests, smoke)


def check_chunk(t: int, chunk: int) -> None:
    """The kernel takes every chunk from 1 to 64 that divides T (the model
    path's ``_fit_chunk`` gives a 12-token prompt chunk 12)."""
    if chunk < 1 or chunk > MAX_CHUNK or t % chunk:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK} and divide T={t}, "
                         f"got {chunk}")


def rwkv6_chunked_plain(q_in: torch.Tensor, q_intra: torch.Tensor,
                        k_intra: torch.Tensor, k_out: torch.Tensor,
                        v: torch.Tensor, decay: torch.Tensor, *, chunk: int,
                        exclusive: bool = True,
                        initial_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 (o (BH, T, V), final S (BH, K, V)) on the inputs' device."""
    bh, t, dk = q_in.shape
    dv = v.shape[-1]
    nc = t // chunk
    S = (initial_state.float() if initial_state is not None else
         torch.zeros((bh, dk, dv), dtype=torch.float32, device=q_in.device))
    r = torch.arange(chunk, device=q_in.device)
    mask = r[:, None] > r[None, :] if exclusive else r[:, None] >= r[None, :]
    qi, qa, ka, ko = (x.float().reshape(bh, nc, chunk, dk)
                      for x in (q_in, q_intra, k_intra, k_out))
    vc = v.float().reshape(bh, nc, chunk, dv)
    outs = []
    for c in range(nc):
        scores = torch.where(mask, qa[:, c] @ ka[:, c].transpose(1, 2), 0.0)
        outs.append(qi[:, c] @ S + scores @ vc[:, c])
        S = (decay[:, c, :, None].float() * S
             + ko[:, c].transpose(1, 2) @ vc[:, c])
    return torch.stack(outs, dim=1).reshape(bh, t, dv), S


def _check(ins, initial_state, chunk: int) -> None:
    names = ("q_in", "q_intra", "k_intra", "k_out", "v", "decay")
    dev = ins[0].device
    for name, x in zip(names + ("initial_state",), (*ins, initial_state)):
        if x is None:
            continue
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"rwkv6_chunked: {name} must be on q_in's CUDA "
                             f"device, got {x.device}")
        if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
            raise ValueError(f"rwkv6_chunked: {name} must be a contiguous "
                             f"3-D float32 tensor, got {x.dtype} of shape "
                             f"{tuple(x.shape)}")
    bh, t, dk = ins[0].shape
    dv = ins[4].shape[-1]
    want = {"q_intra": (bh, t, dk), "k_intra": (bh, t, dk),
            "k_out": (bh, t, dk), "v": (bh, t, dv)}
    for name, x in zip(names[1:5], ins[1:5]):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"rwkv6_chunked: {name} has shape "
                             f"{tuple(x.shape)}, expected {want[name]}")
    if dk not in KV_DIMS or dv not in KV_DIMS:
        raise ValueError(f"rwkv6_chunked: K={dk} and V={dv} must each be in "
                         f"{KV_DIMS}")
    check_chunk(t, chunk)
    if tuple(ins[5].shape) != (bh, t // chunk, dk):
        raise ValueError(f"rwkv6_chunked: decay has shape "
                         f"{tuple(ins[5].shape)}, expected "
                         f"{(bh, t // chunk, dk)}")
    if (initial_state is not None
            and tuple(initial_state.shape) != (bh, dk, dv)):
        raise ValueError(f"rwkv6_chunked: initial_state has shape "
                         f"{tuple(initial_state.shape)}, expected "
                         f"{(bh, dk, dv)}")


def _lib() -> ctypes.CDLL:
    lib = build.library("rwkv6")
    fn = lib.rwkv6_chunked_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [ctypes.c_longlong, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.rwkv6_smem_bytes.argtypes = [i, i, i]
        lib.rwkv6_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(dk: int, dv: int, chunk: int) -> int:
    """Dynamic shared memory of one CTA."""
    return _lib().rwkv6_smem_bytes(dk, dv, chunk)


def rwkv6_chunked(q_in: torch.Tensor, q_intra: torch.Tensor,
                  k_intra: torch.Tensor, k_out: torch.Tensor, v: torch.Tensor,
                  decay: torch.Tensor, *, chunk: int, exclusive: bool = True,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on contiguous float32 CUDA tensors; returns
    (o (BH, T, V), final S (BH, K, V)), on the current stream."""
    global launches
    ins = (q_in, q_intra, k_intra, k_out, v, decay)
    _check(ins, initial_state, chunk)
    bh, t, dk = q_in.shape
    dv = v.shape[-1]
    out = torch.empty((bh, t, dv), dtype=torch.float32, device=q_in.device)
    s_out = torch.empty((bh, dk, dv), dtype=torch.float32, device=q_in.device)
    s0 = None if initial_state is None else initial_state.data_ptr()
    fn = _lib().rwkv6_chunked_launch
    with torch.cuda.device(q_in.device):
        stream = torch.cuda.current_stream(q_in.device).cuda_stream
        err = fn(*(x.data_ptr() for x in ins), s0, out.data_ptr(),
                 s_out.data_ptr(), bh, t, dk, dv, chunk, int(exclusive),
                 stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_chunked: kernel launch failed with "
                           f"cudaError_t {err}")
    launches += 1
    return out, s_out
