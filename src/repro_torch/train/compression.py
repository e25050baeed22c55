"""Int8 gradient compression with error feedback (EF-SGD style): the port
of ``repro/train/compression.py``.

Gradients are blockwise-int8 quantised (the optimizer's ``_q8``) before the
data-parallel reduction; the quantisation residual is added back into the
next step's gradients, so the compression error does not accumulate.

On DTensor grads (under a mesh) each rank quantises its own rows inside
``local_map``, with the last axis made whole first, so its blocks are the
global leaf's blocks and the result equals the unsharded one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import is_dtensor
from .optimizer import _dq8, _q8
from .tree import Tree, tree_map


def ef_init(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantise and dequantise; 0-d tensors and those under one block pass
    through."""
    if x.dim() == 0 or x.numel() < 128:
        return x
    if is_dtensor(x):
        return _sharded_roundtrip(x)
    q, s = _q8(x)
    return _dq8(q, s, x.shape)


def _sharded_roundtrip(x):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, last = x.device_mesh, x.dim() - 1
    rows = [Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in x.placements]
    out = local_map(lambda t: _dq8(*_q8(t), t.shape), out_placements=rows,
                    in_placements=(rows,),
                    device_mesh=mesh)(x.redistribute(mesh, rows))
    return out.redistribute(mesh, x.placements)


@torch.no_grad()
def ef_compress(grads: Tree, ef_state: Optional[Tree]
                ) -> Tuple[Tree, Optional[Tree]]:
    """(compressed grads, new error state).  ``ef_state`` None: identity."""
    if ef_state is None:
        return grads, None

    def one(g, e):
        gf = g.float() + e
        gq = _roundtrip(gf)
        return gq.to(g.dtype), gf - gq

    out = tree_map(one, grads, ef_state)
    return (tree_map(lambda t: t[0], out),
            tree_map(lambda t: t[1], out))
