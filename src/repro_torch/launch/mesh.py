"""Device order from a vClos grant (the port of ``repro/launch/mesh.py``'s
``vclos_device_order``; the production mesh is the multi-GPU slice's)."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..core.rankmap import mesh_device_order


def vclos_device_order(grant, spec, devices: Optional[Sequence] = None
                       ) -> List:
    """Reorder ``devices`` (default: every local CUDA device) per a vClos
    grant, so that the data-parallel ring is leaf-contiguous."""
    return mesh_device_order(grant.placement, spec, devices)
