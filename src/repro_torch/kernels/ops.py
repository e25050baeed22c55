"""Public entry to the port's kernels.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the kernel's plain
version.  There is no fallback: a CUDA input that the kernel refuses raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_plain


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd)."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"attention: no path for device {q.device}")
    return flash_attention_plain(q, k, v, causal, window)
