"""RWKV6 / Mamba2 chunked recurrence: the Hopper kernel's wrapper and its
plain version.

``rwkv6_fused`` launches ``csrc/rwkv6.cu``, which replaces the Pallas TPU
kernel ``repro/kernels/rwkv6.py::_rwkv_kernel`` together with the decay
precompute and the bonus diagonal that ``repro/kernels/ops.py:97-123`` does
around it in XLA.  It reads the model's q, k (B, H, T, K), v (B, H, T, V)
and log decay (B, H, T, K) once, in their dtype (float32, bf16 or float16)
and through their strides, and returns (out (B, H, T, V) in q's dtype, a view
of a (B, T, H, V) tensor; final S (B, H, K, V) float32) of

    o_chunk = q_in · S + mask(q_intra · k_intraᵀ) · v  [+ (Σ_k q·u·k) · v]
    S      ← diag(exp Lc) · S + k_outᵀ · v

with the strict lower-triangular mask and the bonus diagonal when a bonus u
(H, K) is given (RWKV6) and the inclusive mask otherwise (Mamba2); q_in,
q_intra, k_intra, k_out and exp(Lc) are the scaled tiles that
``rwkv6_inputs`` computes, here formed per chunk inside the kernel, each
exponential as the reference writes it (never e^(a-b) as e^a·e^-b: at
chunk 64 e^L leaves float32's range, which the centring avoids).  Unlike
the TPU kernel it also takes an initial state and returns the final one,
which the one-pass prefill hands to decode.

Its bound at the serving path's shape (B·H 160, T 2048, K = V = 64, chunk
16, bf16) is its 212 MB of bytes, 0.0634 ms at 3.35 TB/s; its float32 work
takes 0.0392 ms, the products at a third of the TF32 rate since they run as
3xTF32 (0.0923 ms if all of it ran at 67 TFLOP/s).  One CTA owns (b·h, VB
columns of V); the next chunk's raw tiles come by cp.async into a 2-deep
ring; the three products run on the tensor cores in 3xTF32.  It takes every
K and V from 1 to ``MAX_DIM`` and every chunk that divides T, as the Pallas
kernel does: a chunk above ``MAX_SUB`` rows (or whose tiles do not fit)
runs in sub-blocks inside the kernel, at the chunk's own exponentials.
:func:`plan` makes the launch plan (VB 32 unless the caller names one, the
sub-block's rows, the threads, the ring or direct loads) on the host, so the
CPU tests can pin it; the kernel's note gives the design.

``rwkv6_fused_plain`` computes the same function as ``rwkv6_inputs`` →
``rwkv6_chunked_plain`` → the bonus diagonal, for the CPU path and the
on-card comparisons.  ``rwkv6_chunked_plain`` on its own is the
counterpart of ``_rwkv_kernel``, on the precomputed float32 inputs.

The model path reaches both through one registered op,
``torch.ops.repro_torch.rwkv6_fused_fwd`` (``kernels/ops.py``), whose FLOP
formula is :func:`flops`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

LOG_DECAY_MIN = -4.0  # per-step clamp; e^-4 ≈ 0.018, far below trained decays
MAX_DIM = 256                    # K and V each in 1..MAX_DIM
MAX_SUB = 64                     # rows of a sub-block inside a chunk
VB_CHOICES = (8, 16, 32, 64)     # V columns per CTA a caller may name
DEFAULT_VB = 32                  # the fastest column block on the serving path
MAX_SMEM = 232448                # bytes of shared memory a CTA can have
RING = 2                         # stages of the cp.async ring
NO_SMEM = -2                     # the library's code: the CTA does not fit
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches = 0          # kernel launches since the last reset (tests, smoke)
last_plan: Optional[dict] = None   # the last launch's VB, sub-block rows,
#                                    threads, loads, smem and chunk
last_shape = None     # (B, H, T, K, V) of the last launch


def check_chunk(t: int, chunk: int) -> None:
    """The kernel takes every chunk that divides T, as the reference's
    Pallas kernel does (the model path's ``_fit_chunk`` gives a 12-token
    prompt chunk 12; RunConfig's 128 runs at 128)."""
    if chunk < 1 or t % chunk:
        raise ValueError(f"chunk must be >= 1 and divide T={t}, got {chunk}")


def _align16(x: int) -> int:
    return (x + 15) & ~15


def layout_bytes(dk: int, vb: int, cs: int, chunk: int, esize: int,
                 ring: bool) -> int:
    """Shared memory of one CTA under a plan, region by region as
    ``csrc/rwkv6.cu::layout`` counts it: the ring of raw rows, the four
    float32 tiles at K padded to 8, v, the scores, S and its next buffer
    (and P and its next where a chunk runs in several sub-blocks) and the
    per-column vectors."""
    kp = (dk + 7) & ~7
    multi = cs < chunk
    return (_align16((RING if ring else 0) * cs * (3 * dk + vb) * esize)
            + _align16((3 * (kp + 4) + kp + 8) * cs * 4)
            + _align16(cs * (vb + 8) * 4)
            + _align16(cs * (((cs + 7) & ~7) + 4) * 4)
            + _align16((4 if multi else 2) * kp * (vb + 8) * 4)
            + _align16((dk + cs + (4 * dk if multi else 0)) * 4))


def _widest_vb(dv: int) -> int:
    """V rounded up to a power of two, at least 8: the widest column block
    that leaves no CTA without a column of its own."""
    wide = 8
    while wide < dv:
        wide *= 2
    return wide


def plan(dk: int, dv: int, chunk: int, esize: int, *,
         vb: Optional[int] = None, rows_aligned: bool = True) -> dict:
    """The launch plan of a call: the widest column block from ``vb`` (or
    ``DEFAULT_VB``, narrowed to V rounded up to a power of two) down to 8
    that fits, with the most rows a sub-block can take (the chunk's, up to
    ``MAX_SUB``, then 32, 16, 8), direct loads first; then the cp.async
    ring if every row is 16-byte aligned (``rows_aligned``), K and V rows
    are whole 16-byte units and the ring fits too.  An explicit ``vb`` is
    kept: ``NO_SMEM`` in "smem" says it cannot fit.  The serving paths keep
    the plans they had with chunks up to 64 (one sub-block a chunk)."""
    if vb is None:
        wide = min(_widest_vb(dv), DEFAULT_VB)
        vbs = [w for w in VB_CHOICES if w <= wide][::-1]
    else:
        vbs = [vb]
    top = min(chunk, MAX_SUB)
    subs = [top] + [c for c in (32, 16, 8) if c < top]
    for w in vbs:
        for cs in subs:
            if layout_bytes(dk, w, cs, chunk, esize, False) > MAX_SMEM:
                continue
            ring = (rows_aligned and (dk * esize) % 16 == 0
                    and (dv * esize) % 16 == 0
                    and layout_bytes(dk, w, cs, chunk, esize, True)
                    <= MAX_SMEM)
            return {"vb": w, "cs": cs, "threads": 256 if w == 64 else 128,
                    "loads": "ring" if ring else "direct",
                    "smem": layout_bytes(dk, w, cs, chunk, esize, ring),
                    "chunk": chunk}
    return {"vb": vbs[-1], "cs": subs[-1],
            "threads": 256 if vbs[-1] == 64 else 128, "loads": "direct",
            "smem": NO_SMEM, "chunk": chunk}


def rows_aligned(tensors) -> bool:
    """Whether every (b, h, t) row of each tensor starts on 16 bytes: the
    base and each walked stride (a dimension of size 1 is never stepped
    over) a multiple of 16 bytes, as ``csrc/rwkv6.cu::aligned16`` holds
    the ring to."""
    for x in tensors:
        if x.data_ptr() % 16 or any(
                n > 1 and (st * x.element_size()) % 16
                for n, st in zip(x.shape[:3], x.stride()[:3])):
            return False
    return True


def flops(b: int, h: int, t: int, dk: int, dv: int, chunk: int) -> int:
    """The work of one call at the kernel's chunk c, per (B, H) T·(2c·(K +
    V) + 4·K·V): each chunk's c x c scores against K and their product with
    V (the whole square, as the tensor cores run it), and per token the
    cross-chunk read q·S and the state update kᵀ·v (K·V multiply-adds
    each)."""
    return b * h * t * (2 * chunk * (dk + dv) + 4 * dk * dv)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rwkv6_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_decay: torch.Tensor, *, chunk: int, exclusive: bool
                 ) -> Tuple[torch.Tensor, ...]:
    """The TPU kernel's inputs, as the reference precomputes them
    elementwise (``repro/kernels/ops.py:97-115``): log decay clamped to
    [LOG_DECAY_MIN, 0], its in-chunk cumsum L, the chunk total Lc, the
    chunk-relative ``center``; then contiguous float32 q_in, q_intra,
    k_intra, k_out (B·H, T, K), v (B·H, T, V) and exp(Lc) (B·H, T/C, K)
    (float64 for float64 inputs, which only the CPU takes)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    nc = t // chunk
    wide = torch.promote_types(q.dtype, torch.float32)
    ld = log_decay.to(wide).clamp(LOG_DECAY_MIN, 0.0).reshape(b, h, nc, chunk,
                                                             dk)
    L = ld.cumsum(dim=3)
    Lc = L[:, :, :, -1:, :]
    L_read = L - ld if exclusive else L
    center = 0.5 * (L_read.amax(dim=3, keepdim=True)
                    + L.amin(dim=3, keepdim=True))
    qf = q.to(wide).reshape(b, h, nc, chunk, dk)
    kf = k.to(wide).reshape(b, h, nc, chunk, dk)

    def flat(x, d):
        return x.reshape(b * h, -1, d).contiguous()
    return (flat(qf * torch.exp(L_read), dk),
            flat(qf * torch.exp(L_read - center), dk),
            flat(kf * torch.exp(center - L), dk),
            flat(kf * torch.exp(Lc - L), dk),
            flat(v.to(wide), dv),
            flat(torch.exp(Lc), dk))


def rwkv6_chunked_plain(q_in: torch.Tensor, q_intra: torch.Tensor,
                        k_intra: torch.Tensor, k_out: torch.Tensor,
                        v: torch.Tensor, decay: torch.Tensor, *, chunk: int,
                        exclusive: bool = True,
                        initial_state: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_rwkv_kernel``'s function on its precomputed inputs: float32
    (o (BH, T, V), final S (BH, K, V)) on the inputs' device."""
    bh, t, dk = q_in.shape
    dv = v.shape[-1]
    nc = t // chunk
    wide = torch.promote_types(q_in.dtype, torch.float32)
    S = (initial_state.to(wide) if initial_state is not None else
         torch.zeros((bh, dk, dv), dtype=wide, device=q_in.device))
    r = torch.arange(chunk, device=q_in.device)
    mask = r[:, None] > r[None, :] if exclusive else r[:, None] >= r[None, :]
    qi, qa, ka, ko = (x.to(wide).reshape(bh, nc, chunk, dk)
                      for x in (q_in, q_intra, k_intra, k_out))
    vc = v.to(wide).reshape(bh, nc, chunk, dv)
    outs = []
    for c in range(nc):
        scores = torch.where(mask, qa[:, c] @ ka[:, c].transpose(1, 2), 0.0)
        outs.append(qi[:, c] @ S + scores @ vc[:, c])
        S = (decay[:, c, :, None].to(wide) * S
             + ko[:, c].transpose(1, 2) @ vc[:, c])
    return torch.stack(outs, dim=1).reshape(bh, t, dv), S


def rwkv6_fused_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_decay: torch.Tensor, *,
                      bonus: Optional[torch.Tensor] = None, chunk: int,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's function in plain PyTorch, as the reference's
    ``rwkv6_mix(implementation="pallas")`` computes it: (out (B, H, T, V) in
    q's dtype, final S (B, H, K, V) float32, float64 for float64 inputs)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    wide = torch.promote_types(q.dtype, torch.float32)
    exclusive = bonus is not None
    ins = rwkv6_inputs(q, k, v, log_decay, chunk=chunk, exclusive=exclusive)
    s0 = (None if initial_state is None else
          initial_state.to(wide).reshape(b * h, dk, dv))
    o, S = rwkv6_chunked_plain(*ins, chunk=chunk, exclusive=exclusive,
                               initial_state=s0)
    out = o.reshape(b, h, t, dv)
    if bonus is not None:
        diag = torch.einsum("bhtk,hk,bhtk->bht", q.to(wide), bonus.to(wide),
                            k.to(wide))
        out = out + diag[..., None] * v.to(wide)
    return out.to(q.dtype), S.reshape(b, h, dk, dv)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _check(q, k, v, log_decay, bonus, chunk, initial_state, vb) -> None:
    named = (("q", q), ("k", k), ("v", v), ("log_decay", log_decay),
             ("bonus", bonus), ("initial_state", initial_state))
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"rwkv6_fused: q must be float16, bf16 or float32, "
                         f"got {q.dtype}")
    for name, x in named[1:4]:
        if x.dtype != q.dtype:
            raise ValueError(f"rwkv6_fused: {name} is {x.dtype}, q is "
                             f"{q.dtype}; the kernel takes one dtype")
    if q.dim() != 4:
        raise ValueError(f"rwkv6_fused: q must be (B, H, T, K), got shape "
                         f"{tuple(q.shape)}")
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    want = {"k": (b, h, t, dk), "v": (b, h, t, dv),
            "log_decay": (b, h, t, dk)}
    for name, x in named[1:4]:
        if tuple(x.shape) != want[name]:
            raise ValueError(f"rwkv6_fused: {name} has shape "
                             f"{tuple(x.shape)}, expected {want[name]}")
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"rwkv6_fused: K={dk} and V={dv} must each be in "
                         f"1..{MAX_DIM}")
    check_chunk(t, chunk)
    if vb is not None and (vb not in VB_CHOICES or vb > _widest_vb(dv)):
        raise ValueError(f"rwkv6_fused: vb={vb} must be one of {VB_CHOICES} "
                         f"and no wider than V={dv} rounded up to a power "
                         f"of two")
    for name, x in named[:4]:
        if x.stride(-1) != 1:
            raise ValueError(f"rwkv6_fused: {name} must have inner stride 1,"
                             f" got strides {x.stride()}")
    if bonus is not None and tuple(bonus.shape) != (h, dk):
        raise ValueError(f"rwkv6_fused: bonus has shape {tuple(bonus.shape)},"
                         f" expected {(h, dk)}")
    if initial_state is not None and initial_state.numel() != b * h * dk * dv:
        raise ValueError(f"rwkv6_fused: initial_state has shape "
                         f"{tuple(initial_state.shape)}, expected "
                         f"{(b, h, dk, dv)} or {(b * h, dk, dv)}")
    for name, x in named:      # last, so the CPU tests reach every check
        if x is not None and (not x.is_cuda or x.device != q.device):
            raise ValueError(f"rwkv6_fused: {name} must be on q's CUDA "
                             f"device, got {x.device}")


def _lib() -> ctypes.CDLL:
    lib = build.library("rwkv6")
    fn = lib.rwkv6_fused_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 8 + [i] * 7 + [p, i, i, i, i, p,
                                            ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return lib


def rwkv6_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, *,
                bonus: Optional[torch.Tensor] = None, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                vb: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on CUDA tensors, read in place through their
    strides (inner stride 1); returns (out (B, H, T, V) in q's dtype, final
    S (B, H, K, V) float32), on the current stream.  :func:`plan` makes the
    launch plan (``last_plan``); ``vb`` overrides its column block (for
    measurement)."""
    global launches, last_plan, last_shape
    build.refuse_grad("rwkv6_fused", q, k, v, log_decay, bonus,
                      initial_state)
    _check(q, k, v, log_decay, bonus, chunk, initial_state, vb)
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    ins = (q, k, v, log_decay)
    how = plan(dk, dv, chunk, q.element_size(), vb=vb,
               rows_aligned=rows_aligned(ins))
    if how["smem"] == NO_SMEM:
        raise ValueError(f"rwkv6_fused: vb={how['vb']} does not fit in a "
                         f"CTA's shared memory at K={dk}, chunk {chunk}, "
                         f"even in sub-blocks of {how['cs']} rows")
    out = torch.empty((b, t, h, dv), dtype=q.dtype, device=q.device)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=q.device)
    u = None if bonus is None else bonus.float().contiguous()   # (H, K)
    s0 = (None if initial_state is None else
          initial_state.float().reshape(b * h, dk, dv).contiguous())
    strides = (ctypes.c_longlong * 12)(*(s for x in ins
                                         for s in x.stride()[:3]))
    smem = ctypes.c_int(0)
    fn = _lib().rwkv6_fused_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(x.data_ptr() for x in ins),
                 None if u is None else u.data_ptr(),
                 None if s0 is None else s0.data_ptr(), out.data_ptr(),
                 s_out.data_ptr(), _DTYPE_CODE[q.dtype], b, h, t, dk, dv,
                 chunk, strides, how["vb"], how["cs"],
                 int(how["loads"] == "ring"), how["threads"], stream,
                 ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"rwkv6_fused: kernel launch failed with "
                           f"{'NO_SMEM' if err == NO_SMEM else 'cudaError_t'}"
                           f" {err} (plan {how})")
    if smem.value != how["smem"]:
        raise RuntimeError(f"rwkv6_fused: the library lays out "
                           f"{smem.value} bytes of shared memory, the plan "
                           f"{how['smem']}")
    launches += 1
    last_shape = (b, h, t, dk, dv)
    last_plan = how
    return out.transpose(1, 2), s_out
