"""ModelContext: the distribution context threaded through model code.

Keeps models mesh-agnostic: every sharding point goes through
``ctx.shard(x, *axes)``, the identity without a mesh (unit tests, one
device) and, under a mesh, a DTensor ``redistribute`` to the placements the
logical axes resolve to (the reference's ``with_sharding_constraint``).
Logical axis names (``parallel/sharding.py`` fills the table):

  "dp"   — data-parallel axes (("pod","data") on the production mesh)
  "tp"   — tensor-parallel (attention heads / ffn / vocab)
  "tp_a" — first factor of the model axis (mesh view), e.g. expert axis
  "tp_b" — second factor
  "sp"   — sequence-parallel target (activations' seq dim)

``ep_axis`` / ``ep_tp_axis`` name the raw mesh axes of the MoE layer's
all-to-all and its expert-internal TP sum (``moe.moe_apply_a2a``).

``maybe_remat`` wraps a layer's block in activation checkpointing, as the
reference's does (``context.py:52-60``): "full" keeps only the block's
inputs and recomputes the rest in the backward; "dots" also keeps the
outputs of the plain matrix products (``aten.mm``), the counterpart of
``checkpoint_dots_with_no_batch_dims``.  A recompute runs the attention and
recurrence kernels again.  The XLA-tiling fields of the reference's
context (``block_q``, ``block_k``, ``full_unroll``) belong to slice 7's
compile-only analysis.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

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
    mesh: Optional[Any] = None              # DeviceMesh (the mesh view)
    axes: Dict[str, Any] = field(default_factory=dict)  # logical -> axes
    ep_axis: Optional[str] = None           # mesh axis of the MoE all-to-all
    ep_tp_axis: Optional[str] = None        # mesh axis of expert-internal TP
    remat: str = "none"                     # none | full | dots
    sequence_parallel: bool = False
    ssm_chunk: int = 16     # chunk of the RWKV6 recurrence (cut by _fit_chunk)

    def resolve(self, *logical: Optional[str]):
        from ..parallel.sharding import P
        return P(*[self.axes.get(a) if a else None for a in logical])

    @property
    def dmesh(self):
        """The mesh the DTensors live on: ``mesh`` without its axes of size
        1 (``parallel.sharding.compute_mesh``)."""
        from ..parallel.sharding import compute_mesh
        return compute_mesh(self.mesh)

    def placements(self, *logical: Optional[str]):
        """Placements on :attr:`dmesh`."""
        from ..parallel.sharding import spec_placements
        return spec_placements(self.resolve(*logical), self.mesh)

    def shard(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        if self.mesh is None:
            return x
        return x.redistribute(self.dmesh, self.placements(*logical))

    def scope(self):
        """The model code's scope: under a mesh, plain tensors the model
        makes itself (positions, RoPE tables, the aux loss's zero) enter
        DTensor arithmetic as replicated; inputs and parameters are
        DTensors already."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

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
