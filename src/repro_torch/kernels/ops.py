"""Public entry to the port's kernels, differentiable.

A CUDA tensor goes to the Hopper kernel, a CPU tensor to the kernel's plain
version.  There is no fallback: a CUDA input that the kernel refuses raises.
Each model kernel sits inside an autograd ``Function`` whose backward
recomputes through the reference's differentiable plain formulation, as the
reference trains its Pallas forward (``repro/kernels/ops.py:41-72``): the
JAX package has no backward kernel to port.  The kernels' own wrappers fill
their outputs through ``ctypes`` and refuse to run where autograd would need
a graph (``build.refuse_grad``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention, flash_attention_plain
from .rwkv6 import rwkv6_fused, rwkv6_fused_plain


def _check_device(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {x.device}")


class _FlashAttention(torch.autograd.Function):
    """Flash attention forward (the kernel, or its plain version on the CPU)
    with the reference's recompute backward: autograd through
    ``models.attention.blocked_attention`` on the saved q, k, v (GQA
    inside, as the kernel does it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.is_cuda:
            return flash_attention(q, k, v, causal=causal, window=window)
        return flash_attention_plain(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        from ..models.attention import blocked_attention  # models import ops
        with torch.enable_grad():
            ins = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            out = blocked_attention(*ins, causal=ctx.causal,
                                    window=ctx.window)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    _check_device("attention", q)
    return _FlashAttention.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# rwkv6 / mamba2 chunked recurrence
# ---------------------------------------------------------------------------

class _Rwkv6Mix(torch.autograd.Function):
    """The fused recurrence (the kernel, or ``rwkv6_fused_plain`` on the
    CPU) -> (out, final S), both differentiable; the backward recomputes
    through ``models.ssm.chunked_linear_attention_scan``, the reference's
    chunk scan with its bonus diagonal (``repro/models/ssm.py:36-100``)."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, bonus, initial_state, chunk: int):
        ctx.save_for_backward(q, k, v, log_decay, bonus, initial_state)
        ctx.chunk = chunk
        run = rwkv6_fused if q.is_cuda else rwkv6_fused_plain
        return run(q, k, v, log_decay, bonus=bonus, chunk=chunk,
                   initial_state=initial_state)

    @staticmethod
    def backward(ctx, g_out, g_state):
        from ..models.ssm import chunked_linear_attention_scan
        with torch.enable_grad():
            ins = [None if x is None else x.detach().requires_grad_()
                   for x in ctx.saved_tensors]
            q, k, v, ld, u, s0 = ins
            b, h, _, dk = q.shape
            out, S = chunked_linear_attention_scan(
                q, k, v, ld, bonus=u, chunk=ctx.chunk,
                initial_state=None if s0 is None else
                s0.reshape(b, h, dk, v.shape[-1]))
            grads = iter(torch.autograd.grad(
                (out, S), [x for x in ins if x is not None],
                (g_out, g_state)))
        return (*(None if x is None else next(grads) for x in ins), None)


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
    return _Rwkv6Mix.apply(q, k, v, log_decay, bonus, initial_state, chunk)


def rwkv6_mix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_decay: torch.Tensor, *,
              bonus: Optional[torch.Tensor] = None,
              chunk: int = 64) -> torch.Tensor:
    """The reference's ``rwkv6_mix(implementation="pallas")``: the output of
    :func:`rwkv6_mix_state` without the final state."""
    return rwkv6_mix_state(q, k, v, log_decay, bonus=bonus, chunk=chunk)[0]
