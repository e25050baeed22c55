"""Public entry to the port's kernels.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the kernel's plain
version.  There is no fallback: a CUDA input that the kernel refuses raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention, flash_attention_plain
from .rwkv6 import LOG_DECAY_MIN, rwkv6_chunked, rwkv6_chunked_plain


def _check_device(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {x.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd)."""
    _check_device("attention", q)
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_plain(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# rwkv6 / mamba2 chunked recurrence
# ---------------------------------------------------------------------------

def rwkv6_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_decay: torch.Tensor, *, chunk: int, exclusive: bool
                 ) -> Tuple[torch.Tensor, ...]:
    """The kernel's inputs, as the reference precomputes them elementwise
    (``repro/kernels/ops.py:192-207``): log decay clamped to
    [LOG_DECAY_MIN, 0], its in-chunk cumsum L, the chunk total Lc, the
    chunk-relative ``center``; then contiguous float32 q_in, q_intra,
    k_intra, k_out (B·H, T, K), v (B·H, T, V) and exp(Lc) (B·H, T/C, K)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    nc = t // chunk
    ld = log_decay.float().clamp(LOG_DECAY_MIN, 0.0).reshape(b, h, nc, chunk,
                                                             dk)
    L = ld.cumsum(dim=3)
    Lc = L[:, :, :, -1:, :]
    L_read = L - ld if exclusive else L
    center = 0.5 * (L_read.amax(dim=3, keepdim=True)
                    + L.amin(dim=3, keepdim=True))
    qf = q.float().reshape(b, h, nc, chunk, dk)
    kf = k.float().reshape(b, h, nc, chunk, dk)

    def flat(x, d):
        return x.reshape(b * h, -1, d).contiguous()
    return (flat(qf * torch.exp(L_read), dk),
            flat(qf * torch.exp(L_read - center), dk),
            flat(kf * torch.exp(center - L), dk),
            flat(kf * torch.exp(Lc - L), dk),
            flat(v.float(), dv),
            flat(torch.exp(Lc), dk))


def rwkv6_mix_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_decay: torch.Tensor, *,
                    bonus: Optional[torch.Tensor] = None, chunk: int = 64,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v (B, H, T, K/V), log_decay (B, H, T, K) <= 0, bonus (H, K) or
    None, initial_state (B, H, K, V) or None -> (out (B, H, T, V) in q's
    dtype, final state (B, H, K, V) float32).

    The chunked recurrence runs in the kernel on the card and in its plain
    version on the CPU; the bonus diagonal is added after it, as in the
    reference (``ops.py:119-122``)."""
    _check_device("rwkv6_mix", q)
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"rwkv6_mix: T={t} must be a multiple of "
                         f"chunk={chunk}")
    exclusive = bonus is not None
    ins = rwkv6_inputs(q, k, v, log_decay, chunk=chunk, exclusive=exclusive)
    s0 = (None if initial_state is None else
          initial_state.float().reshape(b * h, dk, dv).contiguous())
    run = rwkv6_chunked if q.is_cuda else rwkv6_chunked_plain
    o, S = run(*ins, chunk=chunk, exclusive=exclusive, initial_state=s0)
    out = o.reshape(b, h, t, dv)
    if bonus is not None:
        diag = torch.einsum("bhtk,hk,bhtk->bht", q.float(), bonus.float(),
                            k.float())
        out = out + diag[..., None] * v.float()
    return out.to(q.dtype), S.reshape(b, h, dk, dv)


def rwkv6_mix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_decay: torch.Tensor, *,
              bonus: Optional[torch.Tensor] = None,
              chunk: int = 64) -> torch.Tensor:
    """The reference's ``rwkv6_mix(implementation="pallas")``: the output of
    :func:`rwkv6_mix_state` without the final state."""
    return rwkv6_mix_state(q, k, v, log_decay, bonus=bonus, chunk=chunk)[0]
