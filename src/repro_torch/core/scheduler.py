"""Online isolated scheduler — the launcher-facing API (paper Fig. 7).

Wraps the placement engines behind one object that the training launcher
(``repro.launch.train``) consults before building a mesh:

    sched = IsolatedScheduler(CLUSTER512, strategy="ocs-vclos")
    grant = sched.submit(job_id=0, num_gpus=64)
    if grant is not None:
        devices = mesh_device_order(grant.placement, sched.spec)
        ...build jax mesh, train...
        sched.release(0)

Also hosts the admission-queue logic shared with the simulator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .jobs import Job
from .ocs import ocs_release
from .placement import Placement, PlacementFailure, commit, release
from .routing import SourceRouting
from .topology import ClusterSpec, FabricState

QUEUE_POLICIES = ("fifo", "ff", "edf")


def order_queue(queue: List[Job], policy: str) -> List[Job]:
    """Admission order of waiting jobs under a queueing policy (§9.7).

    ``fifo`` keeps arrival order (callers enforce head-of-line blocking),
    ``ff`` admits fewest-GPU first, ``edf`` earliest-deadline first.  A job
    without a deadline sorts by its arrival time, i.e. as if its deadline
    were the moment it arrived — earlier than contemporaneous deadline
    jobs, but a late arrival can still sort behind an old job's deadline.
    """
    if policy == "fifo":
        return list(queue)
    if policy == "ff":
        return sorted(queue, key=lambda j: j.num_gpus)
    if policy == "edf":
        return sorted(queue, key=lambda j: j.deadline
                      if j.deadline is not None else j.arrival)
    raise ValueError(f"unknown queueing policy {policy!r}; "
                     f"choose from {QUEUE_POLICIES}")


@dataclass
class Grant:
    placement: Placement
    routing: SourceRouting


class IsolatedScheduler:
    """Launcher-facing facade over any *grantable* registered strategy
    (``Strategy.grantable`` — placements realisable as contention-free
    grants on real hardware: ``vclos``, ``ocs-vclos``, and any plugin
    that sets the flag).  The facade itself is the placement context the
    strategy sees (``spec`` / ``state`` / ``seed`` / ``ilp_time_limit``)."""

    def __init__(self, spec: ClusterSpec, strategy: str = "vclos",
                 ilp_time_limit: float = 5.0, seed: int = 0):
        # local import: repro_torch.core.strategies imports QUEUE_POLICIES from
        # this module, so the registry must load lazily here
        from .strategies import get_strategy
        strat = get_strategy(strategy)
        if not strat.grantable:
            raise ValueError(
                f"IsolatedScheduler serves grantable isolated strategies; "
                f"{strat.name!r} is simulation-only — "
                f"use ClusterSimulator for baselines")
        self.spec = spec
        self.strategy_obj = strat
        self.strategy = strat.name
        self.ilp_time_limit = ilp_time_limit
        self.seed = seed
        self.state = FabricState(spec)
        self.grants: Dict[int, Grant] = {}
        self.last_failure: Optional[str] = None

    def submit(self, job_id: int, num_gpus: int,
               job: Optional[Job] = None) -> Optional[Grant]:
        # the fast-fail every placement context owes Strategy.place
        if self.state.num_free_gpus() < num_gpus:
            res: object = PlacementFailure("gpu")
        else:
            res = self.strategy_obj.place(self, job_id, num_gpus, job=job)
        if isinstance(res, PlacementFailure):
            self.last_failure = res.reason
            return None
        commit(self.state, res)
        base = SourceRouting(self.spec)
        maps = dict(base.maps)
        for leaf, rmap in res.routing_maps.items():
            merged = dict(maps.get(leaf, {}))
            merged.update(rmap)
            maps[leaf] = merged
        grant = Grant(placement=res, routing=SourceRouting(self.spec, maps=maps))
        self.grants[job_id] = grant
        return grant

    def release(self, job_id: int) -> None:
        grant = self.grants.pop(job_id, None)
        if grant is None:
            return
        if grant.placement.xconn_ports:
            ocs_release(self.state, grant.placement)
        else:
            release(self.state, job_id)

    def utilization(self) -> float:
        return 1.0 - self.state.num_free_gpus() / self.spec.num_gpus
