"""vClos -> device order: contention-free logical rank ordering.

The port's copy of ``repro/core/rankmap.py``, without JAX.  On real
hardware the order of the devices handed to a collective communicator
determines the ring order of all-reduce / all-gather (and the pairing of
all-to-all).  The paper's requirement (§5.3) is that collective rings be
*leaf-contiguous*: rank i and rank i+1 on the same leaf except at block
boundaries; then every phase of a ring or halving-doubling all-reduce is a
Leaf-wise Permutation and Source Routing is contention-free (Lemma 5.1).

``Placement.gpus`` is already emitted in leaf-block order by the vClos
materializer, so the map is the identity *on purpose*: this module makes
the contract explicit, verifies it, and maps it onto a device list.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..device import resolve_device
from .patterns import all_phases_leafwise
from .placement import Placement
from .topology import ClusterSpec
from .traffic import pairwise_alltoall, ring_allreduce


def leaf_contiguous_order(placement: Placement, spec: ClusterSpec) -> List[int]:
    """Logical rank -> physical GPU, grouped by leaf then server then port.

    Stable-sorts the placement's GPUs by (leaf, gpu): a no-op for vClos
    placements (already blocked) that repairs arbitrary GPU sets (e.g. the
    relaxed / 'best' strategies) into the contention-minimal order.
    """
    return sorted(placement.gpus, key=lambda g: (spec.leaf_of_gpu(g), g))


def verify_ring_leafwise(order: Sequence[int], spec: ClusterSpec) -> bool:
    """Ring allreduce over ``order`` must be Definition-1 conforming."""
    phases = ring_allreduce(order, 1.0)
    return all_phases_leafwise(phases[:1], spec)


def mesh_device_order(placement: Placement, spec: ClusterSpec,
                      devices: Optional[Sequence] = None) -> List:
    """Permute ``devices`` so that walking them in order walks the
    placement's GPUs leaf-contiguously.

    ``devices[i]`` is the device whose host NIC is the placement's slot i
    (it hosts ``placement.gpus[i]``); any sequence works (tests pass
    names).  The default is every local CUDA device,
    ``[torch.device("cuda", i) for i in range(torch.cuda.device_count())]``;
    without a card it raises.
    """
    if devices is None:
        resolve_device("cuda")              # no card: raise, never CPU
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    order = leaf_contiguous_order(placement, spec)
    slots = {g: i for i, g in enumerate(placement.gpus)}
    if len(devices) < len(order):
        raise ValueError(f"need {len(order)} devices, have {len(devices)}")
    return [devices[slots[g]] for g in order]


def dp_axis_ring_flows(order: Sequence[int], spec: ClusterSpec):
    """The DP-axis gradient ring a communicator over ``order`` emits, as
    flows."""
    return ring_allreduce(order, 1.0)[0]


def ep_axis_alltoall_flows(order: Sequence[int], spec: ClusterSpec):
    return pairwise_alltoall(order, 1.0)
