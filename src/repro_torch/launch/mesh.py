"""Production mesh construction and vClos-ordered rank lists: the port of
``repro/launch/mesh.py``.

``make_production_mesh`` and ``make_smoke_mesh`` are functions: importing
this module touches no process group.  Shapes per the deployment target:

    single pod : (data=16, model=16)            = 256 ranks
    multi-pod  : (pod=2, data=16, model=16)     = 512 ranks

The ``pod`` axis is pure data parallelism across pods, the traffic class
the vClos scheduler isolates.  Both build a ``DeviceMesh`` from the world's
ranks in the order the caller gives: ``vclos_device_order`` permutes a
rank list per an IsolatedScheduler grant so that the data-parallel ring is
leaf-contiguous (``core/rankmap.py``).  The caller has made the process
group and chosen its backend; every rank calls these in the same order.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from ..core.rankmap import mesh_device_order


def _mesh(shape, axes, ranks: Optional[Sequence[int]], device: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, the process group has "
            f"{world}; start {n} ranks (torch.distributed world size)")
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if sorted(ranks) != list(range(n)):
        raise ValueError(f"mesh {tuple(shape)}: ranks {ranks} are not a "
                         f"permutation of 0..{n - 1}")
    return DeviceMesh(device, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         ranks: Optional[Sequence[int]] = None,
                         device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, ranks, device)


def make_smoke_mesh(shape=(2, 2), axes=("data", "model"), *,
                    ranks: Optional[Sequence[int]] = None,
                    device: str = "cuda"):
    """A small mesh for tests and single-host runs."""
    return _mesh(shape, axes, ranks, device)


def vclos_device_order(grant, spec, devices: Optional[Sequence] = None
                       ) -> List:
    """Reorder ``devices`` (default: every local CUDA device) per a vClos
    grant, so that the data-parallel ring is leaf-contiguous; given ranks
    (``range(world)``), the rank order of a mesh."""
    return mesh_device_order(grant.placement, spec, devices)
