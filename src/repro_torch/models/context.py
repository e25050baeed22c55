"""ModelContext: the distribution context threaded through model code.

The port runs on one device so far: ``shard`` is the identity.  Model code
still calls it at the reference's sharding points, which is where the
multi-GPU slice will place its collectives.  ``maybe_remat`` wraps a layer's
block in activation checkpointing, as the reference's does (``context.py:
52-60``): "full" keeps only the block's inputs and recomputes the rest in
the backward; "dots" also keeps the outputs of the plain matrix products
(``aten.mm``), the counterpart of ``checkpoint_dots_with_no_batch_dims``.
A recompute runs the attention and recurrence kernels again.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

REMAT_POLICIES = ("none", "full", "dots")


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep every 2-D matrix product (no batch
    dims); recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


@dataclass(frozen=True)
class ModelContext:
    ssm_chunk: int = 16     # chunk of the RWKV6 recurrence (cut by _fit_chunk)
    remat: str = "none"     # none | full | dots

    def shard(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        return x

    def maybe_remat(self, fn, policy: Optional[str] = None):
        mode = policy or self.remat
        if mode == "none":
            return fn
        kw = {"use_reentrant": False}
        if mode == "dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        elif mode != "full":
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                             f"{mode!r}")
        return functools.wraps(fn)(
            lambda *args, **kwargs: ckpt.checkpoint(fn, *args, **kw,
                                                    **kwargs))


NULL_CTX = ModelContext()
