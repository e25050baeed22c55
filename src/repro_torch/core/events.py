"""Dynamic cluster events: preemption, failures, elastic resize, defrag.

Production GPU-cluster traces are not arrive→run→finish: they are dominated
by churn — preemptions, hardware failures, and elastic jobs growing or
shrinking mid-run (the same event mix CASSINI, arXiv:2308.00852, and the RL
contention scheduler, arXiv:2310.20209, treat as first-class).  This module
is the data model for that churn; the two simulator engines consume it
through ``SimConfig.events`` (see :mod:`repro_torch.core.simulator`) and stay
bit-identical under it.

Event kinds (:data:`EVENT_KINDS`):

  * ``preempt``        — stop a running job; it re-queues with its settled
                         remaining work plus a checkpoint-restart penalty
                         (``restart_iters`` extra iterations, clamped so a
                         job never owes more work than it started with).
  * ``server-fail``    — a server goes down: every running job holding any
                         GPU on it is killed (checkpoint-restart re-queue)
                         and the server's GPUs are fenced until the paired
                         ``server-recover`` event.
  * ``server-recover`` — the fenced server returns to service.
  * ``link-fail``      — a (leaf, spine) fabric link goes down: jobs with
                         reservations on it or live flows across it are
                         killed, and its remaining free channels are fenced
                         until ``link-recover``.  Routing stays oblivious —
                         a *new* non-isolated placement may still hash onto
                         the fenced link (only reservation-based strategies
                         feel the capacity loss); this mirrors the paper's
                         framing where isolation is a *scheduling* property.
  * ``link-recover``   — the fenced channels return.
  * ``resize``         — elastic job: change ``num_gpus``.  A running job
                         is checkpoint-restarted at the new size; a queued
                         (or future) job simply changes its request.

Fenced resources are held by sentinel owners (:data:`FAIL_GPU_OWNER`,
:data:`FAIL_LINK_OWNER`) inside the ordinary
:class:`repro_torch.core.topology.FabricState` accounting, so every placement
strategy sees failures through the exact state it already reads — no
per-strategy failure code.

Trace generation lives in :func:`repro_torch.core.workloads.generate_events`
(driven by the churn fields of ``WorkloadSpec``); :func:`frag_index` is the
fragmentation measure the simulator samples over time (``frag_series``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List

from .topology import ClusterSpec, FabricState

#: every event kind the simulator engines understand
EVENT_KINDS = ("preempt", "server-fail", "server-recover",
               "link-fail", "link-recover", "resize")

#: sentinel ``gpu_owner`` id fencing the GPUs of a failed server
FAIL_GPU_OWNER = -2
#: sentinel ``link_owner`` id fencing the channels of a failed link
FAIL_LINK_OWNER = -3


@dataclass(frozen=True)
class ClusterEvent:
    """One dynamic event.  Frozen (hashable, picklable — campaign workers
    receive cell configs carrying these) and kind-tagged; unused fields
    keep their ``-1``/``0`` defaults.

    ``restart_iters`` is the checkpoint-restart cost charged to every job
    this event kills: the extra iterations added to its remaining work when
    it restarts (work lost since the last checkpoint plus restore time,
    expressed in iterations so it is placement-independent).
    """

    time: float
    kind: str
    job_id: int = -1          # preempt / resize
    server: int = -1          # server-fail / server-recover
    leaf: int = -1            # link-fail / link-recover
    spine: int = -1
    new_gpus: int = 0         # resize target size
    restart_iters: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; "
                             f"choose from {EVENT_KINDS}")
        if not (self.time >= 0.0):
            raise ValueError(f"event time must be >= 0 (got {self.time})")
        if self.restart_iters < 0:
            raise ValueError("restart_iters must be >= 0")

    # -- JSON round-trip (scheduler-service event log) ----------------------
    def to_json(self) -> Dict:
        """Plain-dict form for the service event log.  Floats survive via
        JSON's shortest-round-trip repr, so ``from_json(to_json(ev)) == ev``
        bit-exactly — the replay/restart contract (docs/service.md) needs
        the replayed event stream to be *identical*, not approximately so."""
        return asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "ClusterEvent":
        return cls(**d)


def validate_events(events: Iterable[ClusterEvent],
                    spec: ClusterSpec) -> List[ClusterEvent]:
    """Check an event list against a cluster shape and return it sorted by
    time (stable, so same-time events keep their input order — the order
    the engines will apply them in)."""
    out = []
    for ev in events:
        if not isinstance(ev, ClusterEvent):
            raise TypeError(f"expected ClusterEvent, got {ev!r}")
        if ev.kind in ("server-fail", "server-recover") and \
                not 0 <= ev.server < spec.num_servers:
            raise ValueError(f"{ev.kind} server {ev.server} out of range "
                             f"[0, {spec.num_servers})")
        if ev.kind in ("link-fail", "link-recover") and not (
                0 <= ev.leaf < spec.num_leafs
                and 0 <= ev.spine < spec.num_spines):
            raise ValueError(f"{ev.kind} link ({ev.leaf},{ev.spine}) out of "
                             f"range for {spec.num_leafs}x{spec.num_spines}")
        if ev.kind == "resize" and ev.new_gpus < 1:
            raise ValueError(f"resize to {ev.new_gpus} GPUs (need >= 1)")
        out.append(ev)
    out.sort(key=lambda e: e.time)
    return out


def frag_index(state: FabricState) -> float:
    """Fragmentation of the currently idle capacity, in [0, 1].

    ``1 − (idle GPUs sitting in whole idle servers) / (total idle GPUs)``:
    the fraction of idle capacity *stranded* in partially-occupied servers.
    Whole idle servers are the placement currency of every locality stage
    (stage 0/1, FINDVCLOS, OCS-vClos), so stranded GPUs can only ever serve
    sub-server jobs — the paper's Table-2 fragmentation story (jobs blocked
    by *where* capacity is, not how much) as a single number the simulator
    samples over time.  0 on an empty or fully-packed cluster; 1 when idle
    GPUs exist but no server is wholly free.
    """
    free = state.num_free_gpus()
    if free == 0:
        return 0.0
    whole = int(state.idle_server_counts().sum()) * state.spec.gpus_per_server
    return 1.0 - whole / free
