"""Arithmetic the per-layer metrics' readers share: a wrapped call's least
time on the card from the shapes it recorded, and the shares they
report."""

from __future__ import annotations

from typing import Optional

from . import counts


def _rate(esize: int) -> str:
    return "f32" if esize == 4 else "bf16"


def attn_least(q, k, causal, window, backward: bool = False) -> float:
    """Least seconds of an attention call (forward or its backward) from
    the summaries of q (B, Sq, Hq, hd) and k (B, Skv, Hkv, hd)."""
    b, sq, hq, hd = q["shape"]
    skv, hkv = k["shape"][1], k["shape"][2]
    if backward:
        flops = counts.attn_bwd_flops(b, sq, skv, hq, hd, causal, window)
        nbytes = counts.attn_bwd_bytes(b, sq, skv, hq, hkv, hd, q["esize"])
    else:
        flops = counts.attn_fwd_flops(b, sq, skv, hq, hd, causal, window)
        nbytes = counts.attn_fwd_bytes(b, sq, skv, hq, hkv, hd, q["esize"])
    return counts.least_seconds(nbytes, **{_rate(q["esize"]): flops})


def rwkv6_least(q, v, bonus, chunk, backward: bool = False) -> float:
    """Least seconds of a recurrence call from the summaries of q
    (B, H, T, K), v (B, H, T, V) and the bonus (H, K)."""
    b, h, t, dk = q["shape"]
    fn = counts.rwkv6_bwd_seconds if backward else counts.rwkv6_fwd_seconds
    return fn(b * h, t, dk, v["shape"][-1], chunk, h, q["esize"])


def share(least_s: float, device_s: float) -> Optional[float]:
    """Least time over measured device time, in percent; nothing where the
    trace holds no device time to divide by."""
    if not device_s:
        return None
    return 100.0 * least_s / device_s


def idle_share(view) -> Optional[float]:
    """Over the segment traced with the device's activity alone."""
    trace = view.device_trace
    if not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
