"""Public entry to the port's kernels.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the kernel's plain
version.  There is no fallback: a CUDA input that the kernel refuses raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention, flash_attention_plain
from .rwkv6 import rwkv6_fused, rwkv6_fused_plain


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

def rwkv6_mix_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_decay: torch.Tensor, *,
                    bonus: Optional[torch.Tensor] = None, chunk: int = 64,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v (B, H, T, K/V), log_decay (B, H, T, K) <= 0, bonus (H, K) or
    None, initial_state (B, H, K, V) or None -> (out (B, H, T, V) in q's
    dtype, final state (B, H, K, V) float32).

    On the card the fused kernel reads the model's tensors as they are and
    does the decay precompute and the bonus diagonal itself; on the CPU the
    plain version computes them as the reference does (``ops.py:97-123``)."""
    _check_device("rwkv6_mix", q)
    if q.shape[2] % chunk:
        raise ValueError(f"rwkv6_mix: T={q.shape[2]} must be a multiple of "
                         f"chunk={chunk}")
    run = rwkv6_fused if q.is_cuda else rwkv6_fused_plain
    return run(q, k, v, log_decay, bonus=bonus, chunk=chunk,
               initial_state=initial_state)


def rwkv6_mix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_decay: torch.Tensor, *,
              bonus: Optional[torch.Tensor] = None,
              chunk: int = 64) -> torch.Tensor:
    """The reference's ``rwkv6_mix(implementation="pallas")``: the output of
    :func:`rwkv6_mix_state` without the final state."""
    return rwkv6_mix_state(q, k, v, log_decay, bonus=bonus, chunk=chunk)[0]
