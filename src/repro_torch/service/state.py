"""Live cluster state for the online scheduler daemon.

The port's copy of the reference's ``service/state.py``.  The offline
campaigns replay a whole trace through
:class:`repro_torch.core.simulator.ClusterSimulator` in one ``run()`` call.
The scheduler *service* needs the same engine driven incrementally: jobs
are submitted one at a time, churn events arrive out of band, and the
daemon must survive a crash.  :class:`LiveCluster` is that incremental
driver:

* it hosts one v2 :class:`ClusterSimulator` and steps it with the **exact**
  event-loop semantics of ``_run_v2`` (lazy-deletion completion heap,
  finish → event → arrival tie order, state-version bumps, try-schedule +
  recompute after every mutation) — so a recorded trace fed through
  :func:`replay_trace` yields placements and completion times bit-identical
  to offline ``simulate()`` on the same trace (the differential replay
  oracle, ``tests/test_service.py``),
* every ingested mutation (submit / churn event / clock advance) is
  appended to a durable :class:`ServiceLog` — the
  :class:`~repro_torch.core.runtime.LineJournal` line-atomic format with
  ``fsync`` enabled — before it is applied; a restarted daemon replays the
  log through the same code paths and lands in the exact pre-crash state,
* a **fabric version counter** bumps on every observable state change
  (admitted submit, applied event, completion, clock movement); the
  digital twin (:mod:`repro_torch.service.twin`) memoises what-if answers
  against it.

Time here is *virtual* simulation time, carried on each ingested record
and required to be monotone — the service is a digital twin of the
cluster, not a wall-clock process.  Same-time ordering follows the engine
contract: completions first, then churn events, then submissions
(:func:`replay_trace` merges offline traces in exactly that order).

Every rate resolution of the live engine runs on the cluster's ``device``
(``LiveCluster(..., device=)``, default ``"cuda"``: the segment-max kernel;
``"cpu"``: its plain version).  The device is not part of the event log's
schema: a log written on either device, by either package, resumes in the
other.

Naming note: this package (``repro_torch.service``, the ``schedd`` daemon)
is the *scheduler* service.  It is unrelated to ``repro_torch.serve`` /
``repro_torch.launch.serve``, which decode trained models for inference.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.config import SimConfig
from ..core.events import ClusterEvent, frag_index, validate_events
from ..core.jobs import Job
from ..core.metrics import MetricsReport
from ..core.placement import PlacementFailure
from ..core.runtime import LineJournal
from ..core.simulator import ClusterSimulator
from ..core.topology import ClusterSpec
from ..device import resolve_device

__all__ = ["LiveCluster", "ServiceLog", "RecordingSimulator",
            "drain_completions", "replay_trace", "service_schema",
            "job_to_json", "job_from_json"]

#: job ids at or above this are what-if probes (never logged or persisted)
PROBE_ID_BASE = 2_000_000_000


# ---------------------------------------------------------------------------
# Job (de)serialisation — the submit-record payload
# ---------------------------------------------------------------------------

def job_to_json(job: Job) -> Dict:
    """Submit-record payload: the *input* fields only.  Runtime state
    (start/finish/remaining) is derived deterministically on replay, so
    persisting it would be redundant at best and a divergence risk at
    worst."""
    return {"job_id": job.job_id, "model": job.model,
            "num_gpus": job.num_gpus, "batch_size": job.batch_size,
            "arrival": job.arrival, "num_iters": job.num_iters,
            "allreduce_algo": job.allreduce_algo, "deadline": job.deadline}


def job_from_json(d: Dict) -> Job:
    return Job(job_id=int(d["job_id"]), model=d["model"],
               num_gpus=int(d["num_gpus"]), batch_size=int(d["batch_size"]),
               arrival=float(d["arrival"]), num_iters=int(d["num_iters"]),
               allreduce_algo=d.get("allreduce_algo", "ring"),
               deadline=d.get("deadline"))


# ---------------------------------------------------------------------------
# Event log
# ---------------------------------------------------------------------------

class ServiceLog(LineJournal):
    """Durable event log of the scheduler daemon.

    Same line-atomic format as the campaign :class:`CellJournal` (header +
    JSONL records, torn-tail truncation on resume), but the records are the
    daemon's *inputs* — ``submit`` / ``event`` / ``advance`` / ``drain`` —
    not its outputs: the engine is deterministic, so replaying the input
    stream reconstructs placements, completions, and counters exactly.
    Opens with ``fsync=True`` by default: an acknowledged client request
    must survive power loss, not just a process crash."""

    _LABEL = "service"


def service_schema(spec: ClusterSpec, config: SimConfig,
                   quotas: Optional[Dict[str, int]]) -> Dict:
    """The replay contract: everything that changes how logged records
    apply.  A log replayed under a different strategy/scheduler/cluster
    would diverge silently — so those knobs live in the header and resume
    refuses on mismatch."""
    return {
        "version": ServiceLog.VERSION,
        "cluster": {"num_gpus": spec.num_gpus, "num_leafs": spec.num_leafs,
                    "num_spines": spec.num_spines, "num_ocs": spec.num_ocs},
        "strategy": config.resolve_strategy().name,
        "scheduler": config.scheduler,
        "seed": config.seed,
        "ilp_time_limit": config.ilp_time_limit,
        "quotas": dict(sorted((quotas or {}).items())),
    }


# ---------------------------------------------------------------------------
# Engine plumbing
# ---------------------------------------------------------------------------

class RecordingSimulator(ClusterSimulator):
    """v2 simulator that records every placement commit, in commit order.

    ``placements`` rows are ``(job_id, time, kind, gpus)``.  Used on both
    sides of the differential replay oracle: the service's LiveCluster
    hosts one, and the offline reference run uses one too, so the oracle
    compares *placement decisions* — not just their JCT consequences."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.placements: List[Tuple[int, float, str, Tuple[int, ...]]] = []

    def _add_running_v2(self, job: Job, placement) -> None:
        super()._add_running_v2(job, placement)
        self.placements.append((job.job_id, self.now, placement.kind,
                                tuple(placement.gpus)))


def drain_completions(sim: ClusterSimulator, t: float,
                      ) -> List[Tuple[int, float]]:
    """Process every completion with ``t_fin <= t``, replicating the v2
    run loop exactly: lazy-deletion heap scrub, clock set to each finish
    time, state-version bump, try-schedule, recompute.  Returns the
    ``(job_id, finish_time)`` list in completion order.  Finally moves the
    clock to ``t`` (when finite) — completions tie *before* any same-time
    event or arrival, matching ``_run_v2``'s ``next_finish <= min(...)``."""
    heap = sim._heap
    running = sim.running
    done: List[Tuple[int, float]] = []
    while True:
        while heap:
            _tf, _order, jid, ver = heap[0]
            rj = running.get(jid)
            if rj is None or rj.version != ver:
                heapq.heappop(heap)
                continue
            break
        if not heap or heap[0][0] > t:
            break
        tf, _, fin_id, _ = heapq.heappop(heap)
        sim.now = tf
        rj = sim._remove_running_v2(fin_id)
        sim._finish_job(rj, fin_id)
        sim._state_version += 1
        sim._try_schedule_v2()
        sim._recompute_rates_v2()
        done.append((fin_id, tf))
    if math.isfinite(t) and t > sim.now:
        sim.now = t
    return done


# ---------------------------------------------------------------------------
# LiveCluster
# ---------------------------------------------------------------------------

class LiveCluster:
    """Online scheduler state: one v2 engine, stepped by ingested events.

    Parameters
    ----------
    spec, config:
        Cluster shape and scheduling configuration.  The engine is always
        ``v2`` (the incremental stepping below *is* the v2 loop); churn
        must arrive through :meth:`ingest`, not ``config.events``; defrag
        ticks need the offline loop's clock and are rejected.
    log:
        Optional :class:`ServiceLog` to append ingested records to.  Use
        :meth:`open` to create/resume a durable instance.
    quotas:
        Per-tenant concurrent-GPU caps (running + queued demand).  Missing
        tenants are uncapped.
    device:
        Where the live engine resolves rates: ``"cuda"`` (default; raises
        where there is no card) or ``"cpu"``.
    """

    def __init__(self, spec: ClusterSpec, config: Optional[SimConfig] = None,
                 *, log: Optional[ServiceLog] = None,
                 quotas: Optional[Dict[str, int]] = None,
                 device: str = "cuda"):
        config = config or SimConfig()
        if config.events:
            raise ValueError("LiveCluster ingests events online; leave "
                             "SimConfig.events empty and call ingest()")
        if config.defrag_interval > 0:
            raise ValueError("LiveCluster does not run defrag ticks "
                             "(defrag_interval must be 0)")
        config = config.with_overrides(engine="v2")
        self.spec = spec
        self.config = config
        self.quotas: Dict[str, int] = dict(quotas or {})
        self.sim = RecordingSimulator(spec, config=config, device=device)
        # the engine-dispatch tuple run() would normally bind — the event
        # handlers (_handle_event -> _ops[2]/_ops[3]) go through it
        self.sim._ops = (self.sim._remove_running_v2,
                         self.sim._add_running_v2,
                         self.sim._try_schedule_v2,
                         self.sim._recompute_rates_v2)
        self.jobs: List[Job] = []                 # admitted, arrival order
        self.tenants: Dict[int, str] = {}         # job_id -> tenant
        self.completions: List[Tuple[int, float]] = []
        self.version = 0                          # fabric version counter
        self.denied = 0
        self.ingested = 0                         # logged records applied
        self._next_job_id = 0
        self._log = log

    # -- construction / restart --------------------------------------------
    @classmethod
    def open(cls, path: str, spec: ClusterSpec,
             config: Optional[SimConfig] = None,
             quotas: Optional[Dict[str, int]] = None,
             fsync: bool = True, device: str = "cuda") -> "LiveCluster":
        """Create (or crash-resume) a LiveCluster backed by a durable
        event log at ``path``.  On resume the schema header is validated
        and every logged record is replayed through the normal ingestion
        paths — determinism lands the daemon in the exact pre-crash state
        (modulo a torn final record, which was never acknowledged)."""
        import os
        resolve_device(device)   # refuse before the log is created
        cfg = (config or SimConfig()).with_overrides(engine="v2")
        schema = service_schema(spec, cfg, quotas)
        if os.path.exists(path):
            log, records = ServiceLog.open_resume(path, schema, fsync=fsync)
            live = cls(spec, cfg, quotas=quotas, device=device)
            live._replay(records)
            live._log = log
        else:
            live = cls(spec, cfg, quotas=quotas, device=device,
                       log=ServiceLog.create(path, schema, fsync=fsync))
        return live

    def _replay(self, records: Sequence[Dict]) -> None:
        for rec in records:
            kind = rec.get("kind")
            if kind == "submit":
                self.submit(job_from_json(rec["job"]),
                            tenant=rec.get("tenant", "default"), _log=False)
            elif kind == "event":
                self.ingest(ClusterEvent.from_json(rec["ev"]), _log=False)
            elif kind == "advance":
                self.advance(float(rec["t"]), _log=False)
            elif kind == "drain":
                self.drain_all(_log=False)
            else:
                raise ValueError(f"service log record kind {kind!r} "
                                 f"unknown — log written by a newer "
                                 f"runtime?")

    def close(self) -> None:
        if self._log is not None:
            self._log.close()

    # -- clock --------------------------------------------------------------
    @property
    def now(self) -> float:
        return self.sim.now

    def _check_monotonic(self, t: float, what: str) -> None:
        if t < self.sim.now:
            raise ValueError(f"{what} at t={t:g} violates monotonicity: "
                             f"the live clock is already at {self.sim.now:g}")

    def _drain(self, t: float) -> List[Tuple[int, float]]:
        before = self.sim.now
        done = drain_completions(self.sim, t)
        self.completions.extend(done)
        # completions mutate placement state; pure clock movement shifts
        # every what-if prediction's absolute times — both invalidate
        # memoised twin answers, so both bump the fabric version
        if done or self.sim.now != before:
            self.version += 1
        return done

    # -- ingestion ----------------------------------------------------------
    def new_job(self, model: str, num_gpus: int, num_iters: int,
                batch_size: Optional[int] = None,
                arrival: Optional[float] = None,
                allreduce_algo: str = "ring",
                deadline: Optional[float] = None) -> Job:
        """Materialise a submit request into a Job with a service-assigned
        id (daemon-side convenience; the Job is not yet submitted)."""
        from ..core.jobs import BATCHES, PROFILES
        if model not in PROFILES:
            raise ValueError(f"unknown model {model!r}; "
                             f"choose from {sorted(PROFILES)}")
        if batch_size is None:
            batch_size = BATCHES.get(model, (32,))[0]
        job = Job(job_id=self._next_job_id, model=model, num_gpus=num_gpus,
                  batch_size=batch_size,
                  arrival=self.sim.now if arrival is None else arrival,
                  num_iters=num_iters, allreduce_algo=allreduce_algo,
                  deadline=deadline)
        return job

    def admission(self, tenant: str, num_gpus: int) -> Tuple[bool, str]:
        """Pure admission decision: cluster-feasibility + tenant quota
        against current running+queued demand.  Deterministic in the live
        state, so denied submits replay to denials without being treated
        specially in the log."""
        if num_gpus < 1:
            return False, "num_gpus must be >= 1"
        if num_gpus > self.spec.num_gpus:
            return False, (f"job wants {num_gpus} GPUs but the cluster "
                           f"has {self.spec.num_gpus}")
        cap = self.quotas.get(tenant)
        if cap is not None:
            used = self.tenant_usage().get(tenant, 0)
            if used + num_gpus > cap:
                return False, (f"tenant {tenant!r} quota exceeded: "
                               f"{used} + {num_gpus} > {cap} GPUs")
        return True, "ok"

    def tenant_usage(self) -> Dict[str, int]:
        """Concurrent GPU demand per tenant (running + queued jobs)."""
        usage: Dict[str, int] = {}
        for jid, rj in self.sim.running.items():
            t = self.tenants.get(jid, "default")
            usage[t] = usage.get(t, 0) + rj.job.num_gpus
        for job in self.sim.queue:
            t = self.tenants.get(job.job_id, "default")
            usage[t] = usage.get(t, 0) + job.num_gpus
        return usage

    def submit(self, job: Job, tenant: str = "default",
               _log: bool = True) -> Dict:
        """Ingest one job submission at ``job.arrival`` (monotone).

        The record is logged *before* it is applied (write-ahead); the
        admission decision is re-derived on replay from the same state, so
        the log stays a pure input stream."""
        if job.job_id >= PROBE_ID_BASE:
            raise ValueError(f"job ids >= {PROBE_ID_BASE} are reserved "
                             f"for what-if probes")
        if job.job_id in self.sim._jobs_by_id:
            raise ValueError(f"duplicate job_id {job.job_id}")
        self._check_monotonic(job.arrival, f"submit of job {job.job_id}")
        if _log and self._log is not None:
            self._log.append_record({"kind": "submit", "tenant": tenant,
                                     "job": job_to_json(job)})
        self.ingested += 1
        self._next_job_id = max(self._next_job_id, job.job_id + 1)
        self._drain(job.arrival)
        ok, reason = self.admission(tenant, job.num_gpus)
        if not ok:
            self.denied += 1
            return {"job_id": job.job_id, "admitted": False,
                    "reason": reason, "t": self.sim.now}
        sim = self.sim
        self.jobs.append(job)
        self.tenants[job.job_id] = tenant
        sim._jobs_by_id[job.job_id] = job
        sim.queue.append(job)
        if sim._try_schedule_v2():
            sim._recompute_rates_v2()
        self.version += 1
        placed = job.job_id in sim.running
        out = {"job_id": job.job_id, "admitted": True, "placed": placed,
               "queued": len(sim.queue), "t": self.sim.now}
        if placed:
            p = sim.running[job.job_id].placement
            out["kind"] = p.kind
            out["gpus"] = list(p.gpus)
        return out

    def ingest(self, ev: ClusterEvent, _log: bool = True) -> Dict:
        """Ingest one churn event (preempt / fail / recover / resize) at
        ``ev.time``.  Same-time completions are processed first, matching
        the offline tie order."""
        validate_events([ev], self.spec)
        self._check_monotonic(ev.time, f"{ev.kind} event")
        if _log and self._log is not None:
            self._log.append_record({"kind": "event", "ev": ev.to_json()})
        self.ingested += 1
        self._drain(ev.time)
        self.sim._handle_event(ev)
        self.version += 1
        # _handle_event always logs (now, kind, a, b, n_affected)
        return {"kind": ev.kind, "t": self.sim.now,
                "n_affected": self.sim.event_log[-1][4]}

    def advance(self, t: float, _log: bool = True) -> List[Tuple[int, float]]:
        """Advance the virtual clock to ``t``, processing completions on
        the way.  Returns the ``(job_id, finish_time)`` completions."""
        self._check_monotonic(t, "advance")
        if _log and self._log is not None:
            self._log.append_record({"kind": "advance", "t": t})
        self.ingested += 1
        return self._drain(t)

    def drain_all(self, _log: bool = True) -> List[Tuple[int, float]]:
        """Run every pending completion (and whatever the freed capacity
        admits, transitively) without advancing past the last finish."""
        if _log and self._log is not None:
            self._log.append_record({"kind": "drain"})
        self.ingested += 1
        return self._drain(math.inf)

    # -- queries (read-only) -------------------------------------------------
    def probe_place(self, job: Job) -> Dict:
        """Where would ``job`` go *right now*?  Pure query: the placement
        functions never mutate fabric state (the engine's failed-placement
        memoisation depends on that), and nothing is committed.  Bounded
        latency: O(1) fast-fail when free GPUs < request, and MILP
        fallbacks are wall-clock-capped by ``config.ilp_time_limit``."""
        res = self.sim._place(job)
        if isinstance(res, PlacementFailure):
            return {"placed": False, "reason": res.reason}
        return {"placed": True, "kind": res.kind, "gpus": list(res.gpus)}

    def report(self) -> MetricsReport:
        """Metrics over every admitted job — assembled by the same
        ``build_report`` the offline engine uses (the oracle compares the
        two reports field-for-field)."""
        jobs = sorted(self.jobs, key=lambda j: j.arrival)
        return self.sim.build_report(jobs)

    def stats(self) -> Dict:
        sim = self.sim
        return {"now": sim.now, "version": self.version,
                "strategy": sim.strategy, "scheduler": sim.scheduler,
                "running": len(sim.running), "queued": len(sim.queue),
                "finished": len(self.completions),
                "submitted": len(self.jobs), "denied": self.denied,
                "free_gpus": sim.state.num_free_gpus(),
                "frag_index": frag_index(sim.state),
                "tenant_usage": self.tenant_usage(),
                "quotas": dict(self.quotas),
                "log_path": getattr(self._log, "path", None)}


# ---------------------------------------------------------------------------
# Offline-trace replay through the service loop
# ---------------------------------------------------------------------------

def replay_trace(live: LiveCluster, jobs: Sequence[Job],
                 events: Sequence[ClusterEvent] = (),
                 tenant: str = "default") -> MetricsReport:
    """Feed a recorded offline trace through the service event loop.

    Submissions and churn events are merged into one monotone stream with
    the engine's same-time ordering (events before arrivals; completions
    are drained first inside each ingest), then everything left running is
    drained — after which ``live.report()`` must equal offline
    ``simulate()`` on the same trace bit-for-bit.  This is both the
    differential oracle's driver and ``schedd replay``'s workhorse."""
    ordered_jobs = sorted(jobs, key=lambda j: j.arrival)
    ordered_events = validate_events(events, live.spec)
    stream: List[Tuple[float, int, object]] = []
    stream.extend((ev.time, 0, ev) for ev in ordered_events)
    stream.extend((job.arrival, 1, job) for job in ordered_jobs)
    stream.sort(key=lambda x: (x[0], x[1]))
    for _, tag, item in stream:
        if tag == 0:
            live.ingest(item)
        else:
            live.submit(item, tenant=tenant)
    live.drain_all()
    return live.report()
