"""Event-driven flow-level cluster simulator (RapidNetSim-style, §9.1).

A fluid-rate model: each running job progresses at
``rate = iter_time(share=1) / iter_time(current shares)`` iterations per
ideal-iteration; rates change only when the running set changes (arrival
placement or completion), so the simulation advances event-to-event.

Two engines share one numerical contract (see docs/simulator.md):

  * ``engine="v1"`` — the scan engine: per-event minimum over the running
    set, Counter-backed link loads, per-job rate re-solve in Python.  The
    ``incremental`` flag selects dirty-link-scoped re-solving (default) or
    the faithful full-recompute sweep; both are bit-identical.
  * ``engine="v2"`` — the discrete-event engine (default): a lazy-deletion
    binary heap of completion events keyed ``(finish_time, placement_order)``
    replaces the min-over-running-jobs scan, link load and per-phase flow
    counts live in flat numpy arrays over interned link ids
    (:class:`repro_torch.core.routing.LinkSpace`), rate resolution is batched
    across the affected jobs through
    :func:`repro_torch.core.fairshare.phase_worst_loads` (the Hopper
    segment-max kernel on ``cuda``, its plain version on ``cpu``),
    and failed placements are memoised against a fabric-state version so a
    blocked queue head costs O(1) per event instead of a placement attempt.

Both engines settle a job's remaining work *only when its rate value
changes* (work = elapsed × rate over the constant-rate segment), which makes
completion times independent of how unrelated events partition time — the
invariant that lets v2 cache each completion in a heap entry.  v1 and v2
therefore produce bit-identical schedules (asserted per-strategy by
``tests/test_campaign.py`` and ``benchmarks/bench_campaign.py``).

**Dynamic cluster events** (:mod:`repro_torch.core.events`, docs/events.md) ride
the same loops: job preemption with checkpoint-restart cost, server/link
failure + recovery, elastic GPU resize (``SimConfig.events``), and a
periodic migration-defragmentation pass (``SimConfig.defrag_interval``;
strategies opt in via ``Strategy.supports_migration``).  Every handler is
engine-agnostic — it mutates engine state only through a per-run dispatch
tuple — so the bit-parity contract extends to arbitrary churn
(``tests/test_events.py``, hypothesis suite in ``tests/test_properties.py``).

Strategies are **plugins**: every per-strategy decision (routing factory,
placement, isolation, failure memoisation, queue-policy compatibility)
lives on a :class:`repro_torch.core.strategies.Strategy` registered in
:mod:`repro_torch.core.strategies` — the engines dispatch through the registry
instance and hold no strategy ``if`` chains.  The bundled plugins:

  * ``best``       — ideal single-switch: no fabric, share = 1 (upper bound)
  * ``sr``         — source routing, locality-packed placement, no isolation
  * ``ecmp``       — 5-tuple-hash routing (the contention baseline)
  * ``balanced``   — least-loaded uplink choice at flow start
  * ``vclos``      — exclusive virtual sub-Clos per job (link reservation)
  * ``ocs-vclos``  — vClos + OCS rewiring of idle circuits
  * ``ocs-relax``  — OCS-vClos with the locality constraint relaxed
                      (Table 5's cautionary column)
  * ``contention-affinity`` — CASSINI-style least-overlap placement over
                      ECMP routing (registered via the public plugin API)

Queueing policies: ``fifo`` (strict head-of-line), ``ff`` (fewest-GPU
first), ``edf`` (earliest deadline first) — §9.7 (see
``repro_torch.core.scheduler.order_queue``).
"""

from __future__ import annotations

import heapq
import math
from collections import Counter
from collections.abc import Iterable
from collections.abc import Sequence as _SequenceABC
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..device import resolve_device
from .config import ENGINES, SimConfig
from .events import (FAIL_GPU_OWNER, FAIL_LINK_OWNER, ClusterEvent,
                     frag_index, validate_events)
from .fairshare import phase_worst_loads
from .jobs import GBPS, Job
from .metrics import MetricsReport, job_metrics
from .ocs import ocs_release
from .placement import Placement, PlacementFailure, commit, release
from .routing import (LinkSpace, SourceRouting, a2a_step_flows,
                      alltoall_link_counts, multi_phase_dense_counts,
                      multi_phase_link_counts)
from .scheduler import order_queue
from .strategies import Strategy, strategy_names
from .topology import ClusterSpec, FabricState

NVLINK_SPEEDUP = 12.0  # intra-server fabric vs one NIC (Tbps NVLink vs 100G)

solves = 0   # v2 rate-resolution solves (phase_worst_loads calls) since reset


class _StrategyNamesView(_SequenceABC):
    """Deprecated alias for the strategy registry.

    ``repro_torch.core.simulator.STRATEGIES`` used to be a frozen tuple; it is
    now a live read-only view of
    :func:`repro_torch.core.strategies.strategy_names`, so runtime-registered
    plugins appear immediately and the alias can never drift from the
    registry (asserted by ``tests/test_strategies.py``).  Prefer the
    registry API in new code.
    """

    def __len__(self) -> int:
        return len(strategy_names())

    def __getitem__(self, i):
        return strategy_names()[i]

    def __iter__(self):
        return iter(strategy_names())

    def __contains__(self, item) -> bool:
        return item in strategy_names()

    def __eq__(self, other) -> bool:
        if not isinstance(other, Iterable):
            return NotImplemented
        return tuple(self) == tuple(other)

    # tuple drop-in compatibility for concatenation; hashing stays
    # disabled (like a list) — a live view's hash would drift whenever a
    # plugin registers, silently breaking dict/set lookups.  Snapshot
    # with tuple(STRATEGIES) when a hashable value is needed.
    __hash__ = None  # type: ignore[assignment]

    def __add__(self, other) -> tuple:
        return tuple(self) + tuple(other)

    def __radd__(self, other) -> tuple:
        return tuple(other) + tuple(self)

    def __repr__(self) -> str:
        return repr(strategy_names())


STRATEGIES = _StrategyNamesView()


# ---------------------------------------------------------------------------
# Running-job bookkeeping (v1: Counter-backed)
# ---------------------------------------------------------------------------

@dataclass
class _RunningJob:
    job: Job
    placement: Placement
    iters_left: float
    iter_ideal: float
    rate: float = 1.0                     # iterations per ideal-iteration-time
    last_update: float = 0.0              # when iters_left was last settled
    t_fin: float = math.inf               # cached completion time
    # phase structures: (kind, per_flow_bytes, [link lists], per-link counts)
    phases: List[Tuple[str, float, List[list], Counter]] = field(default_factory=list)
    union_links: Counter = field(default_factory=Counter)
    intra_server: bool = False
    # straggler model (docs/heterogeneous.md): the slowest member server's
    # relative compute scale; 1.0 on homogeneous fleets (exact no-op)
    compute_scale: float = 1.0

    def iter_effective(self, shares: List[float], link_gbps: float) -> float:
        j = self.job
        c = j.compute_time() / self.compute_scale
        bw_mult = NVLINK_SPEEDUP if self.intra_server else 1.0
        bw = link_gbps * GBPS * bw_mult
        t_ar = t_a2a = 0.0
        for (kind, nbytes, _, _), share in zip(self.phases, shares):
            t = nbytes / (bw * max(share, 1e-9))
            if kind == "a2a":
                t_a2a += t
            else:
                t_ar += t
        return c + max(0.0, t_ar - j.profile.overlap_beta * c) + t_a2a


class _RunJobV2:
    """Array-backed running job (v2 engine).

    Phase link counts are CSR-style over dense link ids: ``cat_idx`` /
    ``cat_cnt`` concatenate every phase's (link, flow-count) pairs,
    ``pptr`` delimits phases, ``cat_ucnt`` aligns the job's per-link union
    count with ``cat_idx`` so one gather computes every phase's contention.
    ``uidx``/``uval`` are the union's sparse form for global-load updates.
    """

    __slots__ = ("job", "placement", "iters_left", "iter_ideal", "rate",
                 "last_update", "t_fin", "intra_server", "compute_scale",
                 "kinds", "nbytes",
                 "nb_arr", "nar", "cat_idx", "cat_cnt", "cat_ucnt", "pptr",
                 "uidx", "uval", "order", "version", "slot")

    def __init__(self, job: Job, placement: Placement, intra: bool):
        self.job = job
        self.placement = placement
        self.iters_left = (float(job.num_iters)
                           if job.remaining_iters is None
                           else job.remaining_iters)
        self.iter_ideal = 1.0
        self.rate = 1.0
        self.last_update = 0.0
        self.t_fin = math.inf
        self.intra_server = intra
        self.compute_scale = 1.0     # straggler scale, set by the builder
        self.kinds: List[str] = []
        self.nbytes: List[float] = []
        self.nb_arr: Optional[np.ndarray] = None    # nbytes as float64 array
        self.nar = 0                                # count of non-a2a phases
        self.cat_idx: Optional[np.ndarray] = None
        self.cat_cnt: Optional[np.ndarray] = None
        self.cat_ucnt: Optional[np.ndarray] = None
        self.pptr: Optional[np.ndarray] = None
        self.uidx: Optional[np.ndarray] = None
        self.uval: Optional[np.ndarray] = None
        self.order = 0
        self.version = 0
        self.slot = -1

    def iter_effective(self, shares: np.ndarray, link_gbps: float) -> float:
        # bit-identical twin of _RunningJob.iter_effective: same per-phase
        # expression; cumsum (not sum) keeps the accumulation strictly
        # left-to-right like the scalar loop — np.sum switches to 8-way
        # unrolled pairwise summation at ≥ 8 elements, which rounds
        # differently.  AR phases are contiguous before the a2a tail, so
        # the two slices reproduce the loop's separate accumulators.
        j = self.job
        c = j.compute_time() / self.compute_scale
        bw_mult = NVLINK_SPEEDUP if self.intra_server else 1.0
        bw = link_gbps * GBPS * bw_mult
        if self.nb_arr is None:
            return c + max(0.0, -j.profile.overlap_beta * c)
        t = self.nb_arr / (bw * np.maximum(shares, 1e-9))
        nar = self.nar
        t_ar = float(t[:nar].cumsum()[-1]) if nar else 0.0
        t_a2a = float(t[nar:].cumsum()[-1]) if len(t) > nar else 0.0
        return c + max(0.0, t_ar - j.profile.overlap_beta * c) + t_a2a


def _settle(rj, now: float) -> None:
    """Charge the constant-rate segment [last_update, now] against the job's
    remaining work.  Called only when the rate *value* is about to change —
    the partition-independence invariant both engines rely on."""
    rj.iters_left -= (now - rj.last_update) * rj.rate / rj.iter_ideal
    rj.last_update = now


def _finish_time(rj, now: float) -> float:
    return now + rj.iters_left * rj.iter_ideal / max(rj.rate, 1e-12)


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

class ClusterSimulator:
    """The engine pair behind :func:`simulate`.

    Configuration arrives either as legacy loose kwargs or as one
    :class:`repro_torch.core.config.SimConfig` (``config=``; loose kwargs
    explicitly passed alongside it override the matching config fields,
    omitted ones keep the config's values — the same precedence rule as
    :func:`simulate`).  All per-strategy behaviour dispatches through the
    :class:`repro_torch.core.strategies.Strategy` resolved from the registry;
    the simulator itself is also the *placement context* handed to
    ``Strategy.place`` (``spec`` / ``state`` / ``seed`` /
    ``ilp_time_limit`` plus the :meth:`dense_link_load` /
    :meth:`leaf_link_load` traffic views).
    """

    def __init__(self, spec: ClusterSpec, strategy=None,
                 scheduler: Optional[str] = None, seed: Optional[int] = None,
                 ilp_time_limit: Optional[float] = None,
                 incremental: Optional[bool] = None,
                 engine: Optional[str] = None,
                 config: Optional[SimConfig] = None, device=None):
        # one precedence rule, shared with simulate(): every loose kwarg
        # explicitly passed alongside a config overrides that config field
        # (how campaigns sweep one base config); omitted kwargs keep the
        # config's values, and without a config they take SimConfig defaults
        if config is None:
            config = SimConfig()
        config = config.with_overrides(strategy=strategy, scheduler=scheduler,
                                       seed=seed,
                                       ilp_time_limit=ilp_time_limit,
                                       incremental=incremental, engine=engine)
        strat = config.resolve_strategy()
        if config.scheduler not in strat.queue_policies:
            raise ValueError(
                f"strategy {strat.name!r} does not support queueing policy "
                f"{config.scheduler!r}; it supports {strat.queue_policies}")
        if strat.requires_ocs and not spec.num_ocs:
            raise ValueError(
                f"strategy {strat.name!r} needs an OCS-equipped cluster "
                f"(spec.num_ocs > 0), e.g. the *_OCS presets")
        self.spec = spec
        self.config = config
        # where rate resolution runs: "cuda" (the default) or "cpu"; not a
        # SimConfig field, so the config stays the reference's field for field
        self.device = resolve_device("cuda" if device is None else device)
        self.strategy_obj: Strategy = strat
        self.strategy = strat.name
        self.isolated = strat.isolated
        self.scheduler = config.scheduler
        self.seed = config.seed
        self.ilp_time_limit = config.ilp_time_limit
        self.incremental = config.incremental
        self.engine = config.engine
        self.state = FabricState(spec)
        self.routing = strat.make_routing(spec, self.seed)
        self.running: Dict[int, object] = {}
        self.queue: List[Job] = []
        self.frag_reason: Dict[int, str] = {}   # job_id -> first blocking cause
        self.slowdowns: Dict[int, float] = {}   # job_id -> JRT / ideal JRT
        self.now = 0.0
        # v1 incremental-rate machinery: maintained global link load,
        # link → jobs index, dirty links/jobs since the last resolution
        self._link_load: Counter = Counter()
        self._link_users: Dict[object, Set[int]] = {}
        self._dirty_links: Set[object] = set()
        self._dirty_jobs: Set[int] = set()
        # v2 array state: dense link ids, flat load vector, dirty-link list,
        # and a link → running-job bitset index — users[l] is a row of
        # uint64 words whose set bits are the slots of jobs crossing link l,
        # so the affected set of an event is one fancy-indexed OR-reduce
        # over the dirty links (little-endian bit unpack, see
        # _recompute_rates_v2) instead of a scan over the running set
        self._ls = LinkSpace(spec)
        self._load = np.zeros(self._ls.nlinks, dtype=np.int64)
        self._dirty_cols: List[np.ndarray] = []
        self._users = np.zeros((self._ls.nlinks, 8), dtype=np.uint64)
        self._slot_map: List[Optional[_RunJobV2]] = [None] * 512
        self._free_slots = list(range(511, -1, -1))
        self._heap: List[Tuple[float, int, int, int]] = []
        self._order_counter = 0
        # failed-placement memoisation: a placement attempt is a pure
        # function of FabricState, so a job that failed at state version V
        # fails again until a commit/release bumps the version.  Strategies
        # whose placement can fail irreproducibly (vclos's wall-clock
        # -limited MILP fallback) opt out via Strategy.memoize_failures
        self._state_version = 0
        self._fail_version: Dict[int, int] = {}
        self._memoize_failures = strat.memoize_failures
        # v2 per-job version continuity across restarts (see _add_running_v2)
        self._ver_base: Dict[int, int] = {}
        # dynamic-events machinery (repro_torch.core.events): the applied-event
        # log / fragmentation time series that end up on the MetricsReport,
        # resource fences held by the failure sentinels, and the defrag
        # clock.  Every member is engine-agnostic — the handlers run the
        # same code under v1 and v2, dispatching through _ops.
        self._events: List[ClusterEvent] = validate_events(config.events,
                                                           spec)
        self._jobs_by_id: Dict[int, Job] = {}
        self._down_servers: Dict[int, List[int]] = {}   # server -> fenced GPUs
        self._down_links: Dict[Tuple[int, int], int] = {}  # (leaf,spine) -> ch
        self._defrag_interval = config.defrag_interval
        self._next_defrag = (config.defrag_interval
                             if config.defrag_interval > 0 else math.inf)
        self.event_log: List[tuple] = []
        self.frag_series: List[List[float]] = []
        self.n_preemptions = 0
        self.n_failures = 0
        self.n_resizes = 0
        self.n_migrations = 0
        self.migration_bytes = 0.0
        self._ops: Optional[tuple] = None   # set per run(): engine dispatch

    # -- strategy plumbing: one registry dispatch, no per-strategy branches --
    def _place(self, job: Job):
        # O(1) fast-fail: fewer free GPUs than requested can only ever yield
        # PlacementFailure("gpu") (every strategy needs num_gpus GPUs), so
        # skip the fabric scans — Strategy.place documents this guarantee
        if self.state.num_free_gpus() < job.num_gpus:
            return PlacementFailure("gpu")
        return self.strategy_obj.place(self, job.job_id, job.num_gpus,
                                       job=job)

    # -- placement-context traffic views (see repro_torch.core.strategies) ---------
    def dense_link_load(self) -> np.ndarray:
        """Current running flow count per link, indexed by
        :class:`repro_torch.core.routing.LinkSpace` dense ids.  Read-only
        (the array is marked non-writeable — a plugin mutating it would
        silently corrupt v2 rate accounting): contention-aware placements
        score candidates against it.  Both engines maintain the same
        integer counts (the v2 engine's flat vector is the ground truth;
        the v1 engine densifies its Counter), so placements decided from
        this view are engine-independent."""
        if self.engine != "v1":
            view = self._load.view()
        else:
            view = np.zeros(self._ls.nlinks, dtype=np.int64)
            id_of = self._ls.id_of
            for l, c in self._link_load.items():
                view[id_of(l)] = c
        view.setflags(write=False)
        return view

    def leaf_link_load(self) -> np.ndarray:
        """Per-leaf fabric traffic: :meth:`dense_link_load` summed over each
        leaf's uplinks and downlinks (one int64 per leaf).  The v1 path
        folds its sparse Counter directly (placement attempts are the v1
        hot path — no O(nlinks) densification); integer sums are order
        -independent, so both paths are exactly equal."""
        s = self.spec
        if self.engine != "v1":
            load, ls = self._load, self._ls
            up = load[:ls.half].reshape(s.num_leafs, -1).sum(axis=1)
            down = load[ls.half:].reshape(s.num_spines, s.num_leafs,
                                          ls.channels).sum(axis=(0, 2))
            return up + down
        out = np.zeros(s.num_leafs, dtype=np.int64)
        for (kind, a, b, _ch), c in self._link_load.items():
            out[a if kind == "up" else b] += c
        return out

    def leaf_comm_duty(self) -> np.ndarray:
        """Per-leaf sum of resident running jobs' communication duty
        cycles (:func:`repro_torch.core.patterns.comm_duty_cycle`) — the
        time-domain load view for phase-compatibility placement
        (``contention-affinity-time``).  A job contributes its duty to
        every leaf hosting at least one of its GPUs.  Engine-agnostic:
        both engines keep the same ``running`` map, and ``math.fsum``
        makes the per-leaf totals independent of iteration order, so
        placements scored from this view are engine-independent."""
        from .patterns import comm_duty_cycle
        s = self.spec
        per_leaf: List[List[float]] = [[] for _ in range(s.num_leafs)]
        for rj in self.running.values():
            d = comm_duty_cycle(rj.job, s.link_gbps)
            if d <= 0.0:
                continue
            for leaf in {s.leaf_of_gpu(g) for g in rj.placement.gpus}:
                per_leaf[leaf].append(d)
        return np.asarray([math.fsum(v) for v in per_leaf])

    # =======================================================================
    # v1 engine: Counter-backed flow/rate machinery + scan event loop
    # =======================================================================

    def _build_running(self, job: Job, placement: Placement) -> _RunningJob:
        spec = self.spec
        gpus = placement.gpus[:job.num_gpus]
        intra = len({spec.server_of_gpu(g) for g in gpus}) == 1
        rj = _RunningJob(job=job, placement=placement,
                         iters_left=(float(job.num_iters)
                                     if job.remaining_iters is None
                                     else job.remaining_iters),
                         iter_ideal=1.0, intra_server=intra,
                         compute_scale=self._straggler_scale(gpus))
        routing = self.routing
        if placement.routing_maps and isinstance(routing, SourceRouting):
            # job-specific source maps over its reserved links
            maps = dict(routing.maps)
            for leaf, rmap in placement.routing_maps.items():
                merged = dict(maps.get(leaf, {}))
                merged.update(rmap)
                maps[leaf] = merged
            routing = SourceRouting(spec, maps=maps)
        route_cache: Dict[Tuple[int, int], list] = {}
        isolated = self.isolated

        def phase_counts(phase) -> Counter:
            if isolated or intra:
                # isolated: link reservation pins share = 1; intra-server:
                # every flow rides NVLink — either way no fabric links
                return Counter()
            src = np.fromiter((f.src for f in phase), dtype=np.int64,
                              count=len(phase))
            dst = np.fromiter((f.dst for f in phase), dtype=np.int64,
                              count=len(phase))
            counts = routing.phase_link_counts(src, dst, job.job_id)
            if counts is not None:
                return counts
            counts = Counter()
            for f in phase:
                key = (f.src, f.dst)
                if key not in route_cache:
                    route_cache[key] = routing.route(f, flow_id=job.job_id)
                for l in route_cache[key]:
                    counts[l] += 1
            return counts

        # allreduce phases: one batched vectorized routing pass per job
        # (falls back to flow-by-flow for stateful/custom-map routings)
        rest: List[Tuple[str, float, Counter]] = []
        metas, asrc, adst, aidx = job.ar_phase_arrays(gpus)
        if isolated or intra:
            rest = [(k, b, Counter()) for k, b in metas]
        else:
            counters = multi_phase_link_counts(routing, asrc, adst, aidx,
                                               len(metas), job.job_id)
            if counters is not None:
                rest = [(k, b, c) for (k, b), c in zip(metas, counters)]
            else:
                rest = [(kind, max((f.nbytes for f in phase), default=0.0),
                         phase_counts(phase))
                        for kind, phase in job.ar_phases(gpus)]
        # collapse long AlltoAll phase chains (N-1 steps) into one aggregate
        # phase: per-link worst-case load, total bytes — keeps the hash
        # -collision contention signal at O(1) phases per job.  A vectorized
        # routing computes the aggregate directly, skipping the ~N² flows.
        n = len(gpus)
        a2a: List[Tuple[str, float, Counter]] = []
        if job.profile.alltoall_bytes > 0 and n >= 2:
            share = job.profile.alltoall_bytes / n
            agg: Optional[Counter] = None
            if n - 1 > 8:
                agg = (Counter() if isolated or intra else
                       alltoall_link_counts(routing, gpus,
                                            flow_id=job.job_id))
            if agg is not None:
                # left-to-right sum of the n-1 per-step shares, matching the
                # seed's `sum(...)` to the last ULP (share*(n-1) rounds
                # differently and would break bit-parity with old outputs)
                a2a = [("a2a", sum([share] * (n - 1)), agg)]
            else:
                a2a = [("a2a", max((f.nbytes for f in ph), default=0.0),
                        phase_counts(ph)) for _, ph in job.a2a_phases(gpus)]
                if len(a2a) > 8:
                    agg = Counter()
                    for _, _, c in a2a:
                        for l, cnt in c.items():
                            agg[l] = max(agg[l], cnt)
                    a2a = [("a2a", sum(b for _, b, _ in a2a), agg)]
        for kind, nbytes, counts in rest + a2a:
            rj.phases.append((kind, nbytes, [], counts))
            for l, c in counts.items():
                rj.union_links[l] = max(rj.union_links[l], c)
        nph = len(rj.phases)
        if intra or not spec.is_hetero:
            ref = [1.0] * nph
        else:
            # contention-free reference shares under per-tier speeds: a
            # phase with fabric links runs at the slower of the NIC and
            # leaf tiers, a link-less phase at NIC speed, an isolated
            # (reserved) phase at the fabric tier — so rate = 1.0 means
            # "as fast as this placement's wiring allows", and every
            # formula degenerates bitwise to 1.0 when the ratios are 1.0
            fab = min(spec.nic_ratio, spec.leaf_ratio)
            if isolated:
                ref = [fab] * nph
            else:
                ref = [fab if counts else spec.nic_ratio
                       for _, _, _, counts in rj.phases]
        rj.iter_ideal = rj.iter_effective(ref, spec.link_gbps)
        return rj

    def _straggler_scale(self, gpus: Sequence[int]) -> float:
        """Slowest member server's compute scale (1.0 when homogeneous) —
        the straggler model: data-parallel iterations synchronise on the
        slowest participant, so the whole job computes at its pace."""
        spec = self.spec
        if spec.server_scale is None:
            return 1.0
        return min(spec.scale_of_server(spec.server_of_gpu(g))
                   for g in gpus)

    # -- running-set mutation (keeps the link index consistent) -------------
    def _add_running(self, job: Job, placement: Placement) -> None:
        rj = self._build_running(job, placement)
        rj.last_update = self.now
        rj.t_fin = _finish_time(rj, self.now)
        self.running[job.job_id] = rj
        for l, c in rj.union_links.items():
            self._link_load[l] += c
            self._link_users.setdefault(l, set()).add(job.job_id)
        if rj.union_links:
            self._dirty_links.update(rj.union_links)
            self._dirty_jobs.add(job.job_id)
        # a job with no fabric links keeps its default rate of 1.0 forever
        # (NVLink-local or reserved), so it never needs a rate re-solve

    def _remove_running(self, jid: int) -> _RunningJob:
        rj = self.running.pop(jid)
        for l, c in rj.union_links.items():
            self._link_load[l] -= c
            if self._link_load[l] <= 0:
                del self._link_load[l]
            users = self._link_users.get(l)
            if users is not None:
                users.discard(jid)
                if not users:
                    del self._link_users[l]
        self._dirty_links.update(rj.union_links)
        self._dirty_jobs.discard(jid)
        return rj

    def _job_rate(self, rj: _RunningJob) -> float:
        """Max-min share → progress rate of one job under the current
        maintained global link load.  Under a hetero spec the share of a
        fabric phase is ``min(nic, leaf / worst)`` — the NIC tier caps what
        one flow can push regardless of fabric headroom — and a link-less
        phase runs at NIC speed; both reduce bitwise to the homogeneous
        ``1.0 / worst`` (and 1.0) when every ratio is 1.0."""
        spec = self.spec
        if spec.is_hetero and not rj.intra_server:
            r_nic, r_leaf = spec.nic_ratio, spec.leaf_ratio
            shares = []
            for kind, nbytes, _links, counts in rj.phases:
                if not counts:
                    shares.append(r_nic)
                    continue
                worst = 1
                for l, cnt in counts.items():
                    other = self._link_load[l] - rj.union_links.get(l, 0)
                    worst = max(worst, other + cnt)
                shares.append(min(r_nic, r_leaf / worst))
        else:
            shares = []
            for kind, nbytes, _links, counts in rj.phases:
                worst = 1
                for l, cnt in counts.items():
                    other = self._link_load[l] - rj.union_links.get(l, 0)
                    worst = max(worst, other + cnt)
                shares.append(1.0 / worst)
        eff = rj.iter_effective(shares, self.spec.link_gbps)
        return rj.iter_ideal / eff if eff > 0 else 1.0

    def _apply_rate(self, rj, new: float) -> None:
        """Install a re-solved rate; settle + re-cache the completion time
        only when the value actually changed (skipping is exact)."""
        if new != rj.rate:
            _settle(rj, self.now)
            rj.rate = new
            rj.t_fin = _finish_time(rj, self.now)

    def _recompute_rates(self) -> None:
        """Resolve progress rates after a running-set change.

        Incremental mode touches newly placed jobs plus every job sharing a
        dirty link; a job whose links all kept their load cannot change rate,
        so skipping it is exact, not approximate.
        """
        if self.isolated:
            # reservations guarantee share = 1 (the _RunningJob default)
            self._dirty_links.clear()
            self._dirty_jobs.clear()
            return
        if self.incremental:
            affected = set(self._dirty_jobs)
            for l in self._dirty_links:
                affected.update(self._link_users.get(l, ()))
            for jid in affected:
                rj = self.running.get(jid)
                if rj is not None:
                    self._apply_rate(rj, self._job_rate(rj))
        else:
            # faithful full-recompute baseline (the seed algorithm): rebuild
            # the global load from scratch, re-solve every running job.  The
            # rebuild equals the maintained counter (integer arithmetic), so
            # both modes produce bit-identical schedules.
            load: Counter = Counter()
            for rj in self.running.values():
                load.update(rj.union_links)
            self._link_load = load
            for rj in self.running.values():
                self._apply_rate(rj, self._job_rate(rj))
        self._dirty_links.clear()
        self._dirty_jobs.clear()
        # ocs-relax keeps locality penalty implicit: scattered placement
        # yields many cross-leaf flows, captured by the shares above.

    # -- v1 event loop -------------------------------------------------------
    def _try_schedule(self) -> bool:
        changed = False
        for job in order_queue(self.queue, self.scheduler):
            res = self._place(job)
            if isinstance(res, PlacementFailure):
                self.frag_reason.setdefault(job.job_id, res.reason)
                if self.scheduler == "fifo":
                    break  # strict head-of-line blocking
                continue
            commit(self.state, res)
            if job.start_time is None:     # keep the FIRST start: JWT is
                job.start_time = self.now  # time-to-first-placement even
            self._add_running(job, res)    # across restart re-queues
            self.queue.remove(job)
            changed = True
        return changed

    def _run_v1(self, arrivals: List[Job], max_time: float) -> None:
        ai = 0
        ei = 0
        events = self._events
        while (ai < len(arrivals) or self.queue or self.running) \
                and self.now < max_time:
            next_arrival = arrivals[ai].arrival if ai < len(arrivals) else math.inf
            next_event = events[ei].time if ei < len(events) else math.inf
            # a defrag tick can only make progress while something runs or
            # further events/arrivals are pending; otherwise it must not
            # keep the clock alive (a permanently unplaceable queued job
            # would spin ticks forever instead of ending the run)
            next_defrag = (self._next_defrag
                           if (self.running or ei < len(events)
                               or ai < len(arrivals)) else math.inf)
            next_finish, fin_id = math.inf, None
            for jid, rj in self.running.items():
                if rj.t_fin < next_finish:
                    next_finish, fin_id = rj.t_fin, jid
            t_next = min(next_arrival, next_finish, next_event, next_defrag)
            if math.isinf(t_next):
                break
            self.now = t_next
            # tie order (shared with v2): finish, event, defrag, arrival —
            # completions free resources before same-instant churn/arrivals
            if fin_id is not None and \
                    next_finish <= min(next_arrival, next_event, next_defrag):
                rj = self._remove_running(fin_id)
                self._finish_job(rj, fin_id)
                self._try_schedule()
                self._recompute_rates()
            elif next_event <= min(next_arrival, next_defrag):
                ev = events[ei]
                ei += 1
                self._handle_event(ev)
            elif next_defrag <= next_arrival:
                self._next_defrag += self._defrag_interval
                self._defrag_pass()
            else:
                job = arrivals[ai]
                ai += 1
                self.queue.append(job)
                if self._try_schedule():
                    self._recompute_rates()

    def _finish_job(self, rj, fin_id: int) -> None:
        rj.job.finish_time = self.now
        ideal = rj.job.num_iters * rj.iter_ideal
        if rj.job.start_time is not None and ideal > 0:
            self.slowdowns[fin_id] = \
                (self.now - rj.job.start_time) / ideal
        if rj.placement.xconn_ports:
            ocs_release(self.state, rj.placement)
        else:
            release(self.state, fin_id, rj.placement)

    # =======================================================================
    # dynamic events — ONE implementation for both engines.  Every handler
    # mutates engine state only through the _ops dispatch tuple (remove /
    # add / try-schedule / recompute-rates bound per run()), so the exact
    # same settle/release/requeue sequence happens under v1 and v2 — the
    # events extension of the bit-parity contract.
    # =======================================================================

    def _preempt_running(self, jid: int, penalty: float) -> None:
        """Checkpoint-stop one running job: settle its work at ``now``,
        free its resources, and re-queue it carrying the remaining
        iterations plus the restart penalty (clamped: a job never owes
        more work than it started with)."""
        remove = self._ops[0]
        rj = self.running[jid]
        _settle(rj, self.now)
        rj = remove(jid)
        job = rj.job
        job.remaining_iters = min(float(job.num_iters),
                                  max(rj.iters_left, 0.0) + penalty)
        if rj.placement.xconn_ports:
            ocs_release(self.state, rj.placement)
        else:
            release(self.state, jid, rj.placement)
        self.queue.append(job)

    def _ev_preempt(self, ev: ClusterEvent):
        if ev.job_id not in self.running:
            return False, ev.job_id, 0, 0      # queued/finished: no-op
        self._preempt_running(ev.job_id, ev.restart_iters)
        self.n_preemptions += 1
        return True, ev.job_id, 0, 1

    def _ev_server_fail(self, ev: ClusterEvent):
        sv = ev.server
        if sv in self._down_servers:
            return False, sv, 0, 0             # already down: no-op
        spec = self.spec
        gps = spec.gpus_per_server
        affected = sorted(jid for jid, rj in self.running.items()
                          if any(g // gps == sv for g in rj.placement.gpus))
        for jid in affected:
            self._preempt_running(jid, ev.restart_iters)
        self.n_failures += len(affected)
        # fence the (now fully idle) server's GPUs behind the sentinel so
        # every strategy's placement sees them as occupied
        gpus = [g for g in spec.gpus_of_server(sv) if self.state.gpu_free(g)]
        self.state.allocate_gpus(FAIL_GPU_OWNER, gpus)
        self._down_servers[sv] = gpus
        return True, sv, 0, len(affected)

    def _ev_server_recover(self, ev: ClusterEvent):
        gpus = self._down_servers.pop(ev.server, None)
        if gpus is None:
            return False, ev.server, 0, 0      # wasn't down: no-op
        self.state.release_job(FAIL_GPU_OWNER, gpus=gpus)
        return True, ev.server, 0, 0

    def _link_flow_users(self, n: int, m: int) -> Set[int]:
        """Running jobs with live flows on any channel of fabric link
        (leaf n, spine m) — computed from each engine's maintained
        link→jobs index (identical contents by the parity contract)."""
        out: Set[int] = set()
        channels = self._ls.channels
        if self.engine != "v1":
            ids = [self._ls.id_of(("up", n, m, c)) for c in range(channels)]
            ids += [self._ls.id_of(("down", m, n, c))
                    for c in range(channels)]
            words = np.bitwise_or.reduce(self._users[np.asarray(ids)], axis=0)
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")
            for s in np.flatnonzero(bits):
                out.add(self._slot_map[s].job.job_id)
            return out
        for c in range(channels):
            out.update(self._link_users.get(("up", n, m, c), ()))
            out.update(self._link_users.get(("down", m, n, c), ()))
        return out

    def _ev_link_fail(self, ev: ClusterEvent):
        n, m = ev.leaf, ev.spine
        if (n, m) in self._down_links:
            return False, n, m, 0              # already down: no-op
        # kill reservation holders (vClos-style) and live-flow users alike
        affected = {j for j in self.state.link_owner.get((n, m), {})
                    if j >= 0}
        affected |= self._link_flow_users(n, m)
        affected = sorted(affected)
        for jid in affected:
            self._preempt_running(jid, ev.restart_iters)
        self.n_failures += len(affected)
        # fence whatever channels remain free; reservation-based strategies
        # now see zero capacity on this link (oblivious routings still may
        # hash new flows onto it — see docs/events.md on the model)
        free = self.state.free_channels(n, m)
        if free > 0:
            self.state.reserve_links(FAIL_LINK_OWNER, {(n, m): free})
        self._down_links[(n, m)] = free
        return True, n, m, len(affected)

    def _ev_link_recover(self, ev: ClusterEvent):
        cnt = self._down_links.pop((ev.leaf, ev.spine), None)
        if cnt is None:
            return False, ev.leaf, ev.spine, 0
        if cnt > 0:
            self.state.unreserve_links(FAIL_LINK_OWNER,
                                       {(ev.leaf, ev.spine): cnt})
        return True, ev.leaf, ev.spine, 0

    def _ev_resize(self, ev: ClusterEvent):
        job = self._jobs_by_id.get(ev.job_id)
        if job is None or job.finish_time is not None:
            return False, ev.job_id, ev.new_gpus, 0
        new = max(1, min(ev.new_gpus, self.spec.num_gpus))
        if new == job.num_gpus:
            return False, ev.job_id, new, 0
        if job.job_id in self.running:
            # checkpoint-restart at the new size: the remaining iterations
            # carry over (work is size-independent; the per-iteration time
            # is re-derived from the new placement)
            self._preempt_running(job.job_id, ev.restart_iters)
            job.num_gpus = new
            self.n_resizes += 1
            return True, ev.job_id, new, 1
        job.num_gpus = new
        self.n_resizes += 1
        # queued: placement prospects changed — retry the queue (a future
        # arrival changes nothing yet)
        return job in self.queue, ev.job_id, new, 0

    _EVENT_HANDLERS = {"preempt": _ev_preempt,
                       "server-fail": _ev_server_fail,
                       "server-recover": _ev_server_recover,
                       "link-fail": _ev_link_fail,
                       "link-recover": _ev_link_recover,
                       "resize": _ev_resize}

    def _handle_event(self, ev: ClusterEvent) -> None:
        changed, a, b, n_affected = self._EVENT_HANDLERS[ev.kind](self, ev)
        self.event_log.append((self.now, ev.kind, a, b, n_affected))
        self.frag_series.append([self.now, frag_index(self.state)])
        if changed:
            # freed/fenced resources invalidate memoised placement failures
            # and may admit (or block) queued jobs; removed flows dirty
            # their links, so rates re-solve exactly like a completion
            self._state_version += 1
            self._ops[2]()   # try-schedule
            self._ops[3]()   # recompute rates

    # -- migration defragmentation ------------------------------------------

    @staticmethod
    def _locality_key(spec: ClusterSpec, gpus: Sequence[int]):
        leafs = {g // spec.gpus_per_leaf for g in gpus}
        servers = {g // spec.gpus_per_server for g in gpus}
        return len(leafs), len(servers)

    def _defrag_pass(self) -> None:
        """One defrag tick: sample the fragmentation index, then (for
        strategies with ``supports_migration``) try to checkpoint-migrate
        each running job to a strictly more local placement — fewer leafs,
        then fewer servers — reclaiming contiguous leaf capacity the way
        the paper's fragmentation argument assumes a defragmenter would.

        A trial re-place happens against the fabric with the job's own
        resources released; if the trial is not strictly better the
        original placement is restored untouched (zero float churn — the
        job's rate trajectory is exactly as if the trial never happened).
        """
        self.frag_series.append([self.now, frag_index(self.state)])
        moved = 0
        if self.strategy_obj.supports_migration and self.running:
            spec = self.spec
            remove, add = self._ops[0], self._ops[1]
            for jid in sorted(self.running):
                rj = self.running[jid]
                p = rj.placement
                if p.xconn_ports:
                    continue    # OCS cross-connects are not re-placeable
                key = self._locality_key(spec, p.gpus)
                n = rj.job.num_gpus
                best_servers = -(-n // spec.gpus_per_server)  # ceil
                if key[0] == 1 and key[1] <= best_servers:
                    continue    # already maximally local
                release(self.state, jid, p)
                res = self._place(rj.job)
                if isinstance(res, PlacementFailure) or \
                        self._locality_key(spec, res.gpus) >= key:
                    commit(self.state, p)   # restore; rj never touched
                    continue
                rj = remove(jid)
                _settle(rj, self.now)
                job = rj.job
                job.remaining_iters = min(
                    float(job.num_iters),
                    max(rj.iters_left, 0.0) + self.config.migration_iters)
                commit(self.state, res)
                self._state_version += 1
                add(job, res)
                self.n_migrations += 1
                self.migration_bytes += job.profile.param_bytes * job.num_gpus
                moved += 1
        self.event_log.append((self.now, "defrag", moved, 0, moved))
        if moved:
            self._ops[2]()      # packed capacity may admit queued jobs
        self._ops[3]()          # no-op when nothing moved

    # =======================================================================
    # v2 engine: dense link arrays, batched rate solve, completion heap
    # =======================================================================

    def _build_running_v2(self, job: Job, placement: Placement) -> _RunJobV2:
        spec = self.spec
        ls = self._ls
        gpus = placement.gpus[:job.num_gpus]
        # one server holds a contiguous GPU-id block, so min/max deciding
        # the same server ⇔ every id does (order-independent)
        gps = spec.gpus_per_server
        intra = min(gpus) // gps == max(gpus) // gps
        rj = _RunJobV2(job, placement, intra)
        rj.compute_scale = self._straggler_scale(gpus)
        isolated = self.isolated
        n = len(gpus)
        mat: Optional[np.ndarray] = None
        metas, asrc, adst, aidx = job.ar_phase_arrays(gpus)
        if isolated or intra:
            for k, b in metas:
                rj.kinds.append(k)
                rj.nbytes.append(b)
            if job.profile.alltoall_bytes > 0 and n >= 2:
                self._append_a2a_meta(rj, job, n)
            # reserved/NVLink: no fabric links, share stays 1 (mat is None)
        else:
            # one routing pass for the whole job: AR phases and the N-1
            # AlltoAll steps concatenate into a single (src, dst, phase)
            # batch — one hash/bincount sweep instead of two
            has_a2a = job.profile.alltoall_bytes > 0 and n >= 2
            nar = len(metas)
            if has_a2a:
                a2a_src, a2a_dst, a2a_step = a2a_step_flows(gpus)
                a2a_idx = nar + a2a_step
                src = np.concatenate([asrc, a2a_src])
                dst = np.concatenate([adst, a2a_dst])
                pidx = np.concatenate([aidx, a2a_idx])
                nphases = nar + n - 1
            else:
                src, dst, pidx, nphases = asrc, adst, aidx, nar
            mat = multi_phase_dense_counts(self.routing, ls, src, dst,
                                           pidx, nphases, job.job_id)
            if mat is None:
                # stateful routing (balanced): build through the Counter
                # path so route() sees the same flow sequence, then densify
                return self._densify_v1_build(job, placement, rj)
            for k, b in metas:
                rj.kinds.append(k)
                rj.nbytes.append(b)
            if has_a2a and self._append_a2a_meta(rj, job, n):
                mat = np.vstack([mat[:nar],
                                 mat[nar:].max(axis=0, keepdims=True)])
        if mat is not None:
            self._attach_dense_phases(rj, mat)
        self._seal_v2(rj, mat)
        return rj

    @staticmethod
    def _append_a2a_meta(rj: _RunJobV2, job: Job, n: int) -> bool:
        """kinds/nbytes of the AlltoAll phases — aggregate-collapsed to one
        phase when n-1 > 8, one phase per step otherwise.  Returns whether
        the collapse applies.  The byte accounting (``share = bytes/n``,
        the left-to-right ``sum([share]*(n-1))``) must stay ULP-identical
        to v1's ``_build_running``; this is the single v2 copy."""
        share = job.profile.alltoall_bytes / n
        if n - 1 > 8:
            rj.kinds.append("a2a")
            rj.nbytes.append(sum([share] * (n - 1)))
            return True
        for _ in range(n - 1):
            rj.kinds.append("a2a")
            rj.nbytes.append(share)
        return False

    def _seal_v2(self, rj: _RunJobV2,
                 mat: Optional[np.ndarray] = None) -> None:
        """Freeze the phase byte counts into array form and compute the
        contention-free iteration time.  ``mat`` (per-phase dense link
        counts, when the dense build produced one) tells the hetero path
        which phases touch fabric links — the same fabric/NIC reference
        share rule as ``_build_running`` (bitwise twin)."""
        if rj.kinds:
            rj.nb_arr = np.asarray(rj.nbytes, dtype=np.float64)
            rj.nar = sum(1 for k in rj.kinds if k != "a2a")
        spec = self.spec
        n = len(rj.kinds)
        if rj.intra_server or not spec.is_hetero:
            ref = np.ones(n)
        else:
            fab = min(spec.nic_ratio, spec.leaf_ratio)
            if self.isolated:
                ref = np.full(n, fab)
            elif mat is None:
                ref = np.full(n, spec.nic_ratio)
            else:
                ref = np.where(mat.any(axis=1), fab, spec.nic_ratio)
        rj.iter_ideal = rj.iter_effective(ref, spec.link_gbps)

    def _densify_v1_build(self, job: Job, placement: Placement,
                          rj: _RunJobV2) -> _RunJobV2:
        ls = self._ls
        rj1 = self._build_running(job, placement)
        rows = []
        for kind, nbytes, _links, counts in rj1.phases:
            rj.kinds.append(kind)
            rj.nbytes.append(nbytes)
            row = np.zeros(ls.nlinks, dtype=np.int64)
            for l, c in counts.items():
                row[ls.id_of(l)] = c
            rows.append(row)
        if rows and rj1.union_links:
            self._attach_dense_phases(rj, np.vstack(rows))
        self._seal_v2(rj)
        # the Counter build already computed the same contention-free
        # iteration time; keep the v1-built float verbatim
        rj.iter_ideal = rj1.iter_ideal
        return rj

    def _attach_dense_phases(self, rj: _RunJobV2, mat: np.ndarray) -> None:
        union = mat.max(axis=0)
        uidx = np.nonzero(union)[0]
        if not len(uidx):
            return
        rj.uidx = uidx
        rj.uval = union[uidx]
        nz_ph, nz_l = np.nonzero(mat)
        rj.cat_idx = nz_l
        rj.cat_cnt = mat[nz_ph, nz_l]
        rj.cat_ucnt = union[nz_l]
        rj.pptr = np.searchsorted(nz_ph, np.arange(mat.shape[0] + 1))

    def _alloc_slot(self, rj: _RunJobV2) -> int:
        if not self._free_slots:
            # double the bitset width; existing slot bits are untouched
            nslots = len(self._slot_map)
            self._users = np.hstack(
                [self._users, np.zeros_like(self._users)])
            self._slot_map.extend([None] * nslots)
            self._free_slots = list(range(2 * nslots - 1, nslots - 1, -1))
        slot = self._free_slots.pop()
        self._slot_map[slot] = rj
        return slot

    def _add_running_v2(self, job: Job, placement: Placement) -> None:
        rj = self._build_running_v2(job, placement)
        rj.last_update = self.now
        rj.t_fin = _finish_time(rj, self.now)
        rj.order = self._order_counter
        self._order_counter += 1
        # version numbers continue across preemption/migration restarts of
        # the same job id, so stale heap entries from an earlier incarnation
        # can never alias a fresh one (lazy deletion stays sound)
        rj.version = self._ver_base.get(job.job_id, 0)
        self.running[job.job_id] = rj
        if rj.uidx is not None:
            self._load[rj.uidx] += rj.uval
            self._dirty_cols.append(rj.uidx)
            rj.slot = self._alloc_slot(rj)
            self._users[rj.uidx, rj.slot >> 6] |= np.uint64(1 << (rj.slot & 63))
        heapq.heappush(self._heap, (rj.t_fin, rj.order, job.job_id,
                                    rj.version))

    def _remove_running_v2(self, jid: int) -> _RunJobV2:
        rj = self.running.pop(jid)
        self._ver_base[jid] = rj.version + 1
        if rj.uidx is not None:
            self._load[rj.uidx] -= rj.uval
            self._dirty_cols.append(rj.uidx)
            self._users[rj.uidx, rj.slot >> 6] &= np.uint64(
                ~(1 << (rj.slot & 63)) & 0xFFFFFFFFFFFFFFFF)
            self._slot_map[rj.slot] = None
            self._free_slots.append(rj.slot)
        return rj

    def _recompute_rates_v2(self) -> None:
        if self.isolated:
            return
        if not self._dirty_cols:
            return
        dirty = (self._dirty_cols[0] if len(self._dirty_cols) == 1
                 else np.concatenate(self._dirty_cols))
        self._dirty_cols.clear()
        if self.incremental:
            # one OR-reduce over the dirty links' user bitsets gives every
            # affected job's slot (x86/arm little-endian word layout)
            words = np.bitwise_or.reduce(self._users[dirty], axis=0)
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")
            affected = [self._slot_map[s] for s in np.flatnonzero(bits)]
        else:
            affected = [rj for rj in self.running.values()
                        if rj.uidx is not None]
        if not affected:
            return
        # batched contended-subgraph solve: one gather + segmented max over
        # every affected job's phases (the segment-max kernel on cuda, its
        # plain version on cpu — integer output either way)
        if len(affected) == 1:
            rj0 = affected[0]
            vals = self._load[rj0.cat_idx] - rj0.cat_ucnt + rj0.cat_cnt
            ptr = rj0.pptr
        else:
            idx = np.concatenate([rj.cat_idx for rj in affected])
            cnt = np.concatenate([rj.cat_cnt for rj in affected])
            ucnt = np.concatenate([rj.cat_ucnt for rj in affected])
            vals = self._load[idx] - ucnt + cnt
            ptrs = [np.asarray([0])]
            off = 0
            for rj in affected:
                ptrs.append(rj.pptr[1:] + off)
                off += rj.pptr[-1]
            ptr = np.concatenate(ptrs)
        global solves
        solves += 1
        worst = phase_worst_loads(vals, ptr, device=self.device)
        gbps = self.spec.link_gbps
        hetero = self.spec.is_hetero
        if hetero:
            r_nic, r_leaf = self.spec.nic_ratio, self.spec.leaf_ratio
        p0 = 0
        for rj in affected:
            nph = len(rj.pptr) - 1
            if hetero:
                # vector twin of the hetero _job_rate: worst == 0 marks a
                # link-less phase (empty CSR segment ⇔ v1's empty Counter,
                # whose entries are always ≥ 1) running at NIC speed;
                # fabric phases cap at min(nic, leaf / worst).  Both
                # reduce bitwise to 1.0 / max(worst, 1) at unit ratios.
                w = worst[p0:p0 + nph]
                shares = np.where(w > 0,
                                  np.minimum(r_nic,
                                             r_leaf / np.maximum(w, 1)),
                                  r_nic)
            else:
                shares = 1.0 / np.maximum(worst[p0:p0 + nph], 1)
            p0 += nph
            eff = rj.iter_effective(shares, gbps)
            new = rj.iter_ideal / eff if eff > 0 else 1.0
            if new != rj.rate:
                _settle(rj, self.now)
                rj.rate = new
                rj.t_fin = _finish_time(rj, self.now)
                rj.version += 1
                heapq.heappush(self._heap, (rj.t_fin, rj.order,
                                            rj.job.job_id, rj.version))

    def _try_schedule_v2(self) -> bool:
        changed = False
        ver = self._state_version
        memo = self._memoize_failures
        if memo and self.scheduler == "fifo" and self.queue and \
                self._fail_version.get(self.queue[0].job_id) == ver:
            return False    # memoised head-of-line block: O(1) per event
        for job in order_queue(self.queue, self.scheduler):
            if memo and self._fail_version.get(job.job_id) == ver:
                # placement is a pure function of fabric state: this job
                # failed at the current state version, so it fails again
                if self.scheduler == "fifo":
                    break
                continue
            res = self._place(job)
            if isinstance(res, PlacementFailure):
                self.frag_reason.setdefault(job.job_id, res.reason)
                self._fail_version[job.job_id] = ver
                if self.scheduler == "fifo":
                    break  # strict head-of-line blocking
                continue
            commit(self.state, res)
            ver = self._state_version = self._state_version + 1
            if job.start_time is None:     # first start only (see v1 twin)
                job.start_time = self.now
            self._add_running_v2(job, res)
            self.queue.remove(job)
            changed = True
        return changed

    def _run_v2(self, arrivals: List[Job], max_time: float) -> None:
        ai = 0
        ei = 0
        events = self._events
        heap = self._heap
        running = self.running
        while (ai < len(arrivals) or self.queue or running) \
                and self.now < max_time:
            next_arrival = arrivals[ai].arrival if ai < len(arrivals) else math.inf
            next_event = events[ei].time if ei < len(events) else math.inf
            # progress-gated exactly like the v1 twin (see there): a tick
            # alone must never keep a dead-ended run alive
            next_defrag = (self._next_defrag
                           if (running or ei < len(events)
                               or ai < len(arrivals)) else math.inf)
            # lazy deletion: drop heap entries whose job finished or whose
            # rate changed since the push (version mismatch; restarts keep
            # version numbers monotone per job via _ver_base)
            while heap:
                t, order, jid, ver = heap[0]
                rj = running.get(jid)
                if rj is None or rj.version != ver:
                    heapq.heappop(heap)
                    continue
                break
            next_finish = heap[0][0] if heap else math.inf
            t_next = min(next_arrival, next_finish, next_event, next_defrag)
            if math.isinf(t_next):
                break
            self.now = t_next
            # tie order (shared with v1): finish, event, defrag, arrival
            if heap and \
                    next_finish <= min(next_arrival, next_event, next_defrag):
                _, _, fin_id, _ = heapq.heappop(heap)
                rj = self._remove_running_v2(fin_id)
                self._finish_job(rj, fin_id)
                self._state_version += 1
                self._try_schedule_v2()
                self._recompute_rates_v2()
            elif next_event <= min(next_arrival, next_defrag):
                ev = events[ei]
                ei += 1
                self._handle_event(ev)
            elif next_defrag <= next_arrival:
                self._next_defrag += self._defrag_interval
                self._defrag_pass()
            else:
                job = arrivals[ai]
                ai += 1
                self.queue.append(job)
                if self._try_schedule_v2():
                    self._recompute_rates_v2()

    # -- entry point ---------------------------------------------------------
    def run(self, jobs: Sequence[Job],
            max_time: float = float("inf")) -> MetricsReport:
        # job-id tie-break: coarse real-trace timestamps produce equal
        # arrivals, and FIFO admission order must not depend on the
        # caller's list order (synthetic traces are strictly increasing,
        # so this is a no-op for them — the sort is stable)
        jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        self.now = 0.0
        self._jobs_by_id = {j.job_id: j for j in jobs}
        if self.engine == "batched":
            # lane engine fast path; non-qualifying configs (events,
            # defrag, non-fifo queues, plugin strategies/routings,
            # max_time) fall through to the bit-identical v2 run below
            from .batched import try_run_batched
            rep = try_run_batched(self, list(jobs), max_time)
            if rep is not None:
                return rep
        if self.engine == "v1":
            self._ops = (self._remove_running, self._add_running,
                         self._try_schedule, self._recompute_rates)
            self._run_v1(list(jobs), max_time)
        else:
            self._ops = (self._remove_running_v2, self._add_running_v2,
                         self._try_schedule_v2, self._recompute_rates_v2)
            self._run_v2(list(jobs), max_time)
        return self.build_report(jobs)

    def build_report(self, jobs: Sequence[Job]) -> MetricsReport:
        """Metrics for ``jobs`` (arrival order) against this simulator's
        accumulated counters.  Shared by :meth:`run` and the online
        scheduler service (``repro.service``), whose differential replay
        oracle compares the two reports field-for-field — any report
        assembly living in only one of the paths would silently weaken
        that bit-identity check."""
        rep = job_metrics(jobs)
        rep.frag_gpu = sum(1 for r in self.frag_reason.values() if r == "gpu")
        rep.frag_network = sum(1 for r in self.frag_reason.values()
                               if r == "network")
        rep.slowdowns = [self.slowdowns[j.job_id] for j in jobs
                         if j.job_id in self.slowdowns]
        rep.preemptions = self.n_preemptions
        rep.failures = self.n_failures
        rep.resizes = self.n_resizes
        rep.migrations = self.n_migrations
        rep.migration_bytes = self.migration_bytes
        rep.frag_series = list(self.frag_series)
        rep.event_log = list(self.event_log)
        return rep


def simulate(spec: ClusterSpec, jobs: Sequence[Job], strategy=None,
             scheduler: Optional[str] = None, seed: Optional[int] = None,
             ilp_time_limit: Optional[float] = None,
             incremental: Optional[bool] = None,
             engine: Optional[str] = None,
             config: Optional[SimConfig] = None,
             device=None) -> MetricsReport:
    """Run one trace under one strategy and return its metrics.

    Two equivalent call styles (bit-identical schedules):

      * legacy kwargs — ``simulate(spec, jobs, "ecmp", scheduler="ff")``
      * unified config — ``simulate(spec, jobs, config=SimConfig(...))``

    Any loose kwarg explicitly passed alongside ``config`` overrides that
    config field (``simulate(spec, jobs, "sr", config=base)`` sweeps one
    base config across strategies); omitted kwargs keep the config's
    values.  ``device``: where rate resolution runs, ``"cuda"`` (default;
    raises without a card) or ``"cpu"``.
    """
    if config is None and strategy is None:
        raise ValueError("simulate() needs a strategy name/instance "
                         "or a SimConfig")
    config = (config or SimConfig()).with_overrides(
        strategy=strategy, scheduler=scheduler, seed=seed,
        ilp_time_limit=ilp_time_limit, incremental=incremental,
        engine=engine)
    sim = ClusterSimulator(spec, config=config, device=device)
    # copy jobs so runs under different strategies don't contaminate each other
    import copy
    jobs2 = [copy.copy(j) for j in jobs]
    for j in jobs2:
        j.start_time = None
        j.finish_time = None
        j.remaining_iters = None   # restart state never leaks across runs
    return sim.run(jobs2, max_time=config.max_time)
