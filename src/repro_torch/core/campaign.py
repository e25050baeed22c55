"""Trace-driven simulation campaigns: strategy × policy × load × seed sweeps.

The paper's large-scale results (§9, Tables 5-7, Fig. 12/13) are grids: every
routing/placement strategy crossed with queueing policies, offered loads (λ)
and random seeds, aggregated into JCT/JWT tables and CDFs. This module is
that machinery as a library:

    grid = CampaignGrid(strategies=("ecmp", "sr", "vclos"),
                        loads=(200.0, 120.0), seeds=(0, 1, 2))
    result = run_campaign(CLUSTER512, grid,
                          workload=WorkloadSpec(num_jobs=500))
    for row in result.aggregate():
        print(row)

Each grid cell runs the event-driven simulator on the *same* trace (per
load × seed), so strategy columns are paired samples. ``run_campaign`` also
accepts a fixed external trace (e.g. loaded via
:func:`repro_torch.core.workloads.load_trace_csv`) instead of a synthetic
workload spec. CLI: ``python -m repro_torch.launch.sweep campaign --help``.

Every cell runs its rate resolution on ``device`` (``run_campaign(...,
device=)``, default ``"cuda"``: the segment-max kernel, in this process or
in spawned pool workers; ``"cpu"``: its plain version).  Reports are
identical on both, except the wall-clock fields.
"""

from __future__ import annotations

import contextlib
import copy as _copy
import dataclasses
import functools
import json
import os
import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np

from ..device import resolve_device
from .config import SimConfig
from .jobs import Job
from .metrics import MetricsReport, cdf
from .runtime import (CampaignCell, CellJournal, CellOutcome, CellRunner,
                      FailedCell, atomic_write_text, journal_schema)
from .simulator import simulate
from .scheduler import QUEUE_POLICIES
from .strategies import get_strategy
from .topology import ClusterSpec
from .workloads import (WorkloadSpec, generate_events, generate_trace,
                        trace_stats)


@dataclass(frozen=True)
class CampaignGrid:
    """The swept axes. ``loads`` are mean inter-arrival gaps λ in seconds
    (smaller = heavier offered load); ``schedulers`` are queueing policies."""

    strategies: Tuple[str, ...] = ("best", "vclos", "sr", "ecmp")
    schedulers: Tuple[str, ...] = ("fifo",)
    loads: Tuple[float, ...] = (120.0,)
    seeds: Tuple[int, ...] = (0,)

    def __post_init__(self) -> None:
        for axis in ("strategies", "schedulers", "loads", "seeds"):
            if not getattr(self, axis):
                raise ValueError(f"campaign grid axis {axis!r} is empty")
        for q in self.schedulers:
            if q not in QUEUE_POLICIES:
                raise ValueError(f"unknown queueing policy {q!r}")
        # resolve every strategy (raises listing registered names) and
        # fail fast on incompatible strategy × scheduler cells: a mid
        # -campaign ValueError would discard every completed cell's work
        for s in self.strategies:
            strat = get_strategy(s)
            for q in self.schedulers:
                if q not in strat.queue_policies:
                    raise ValueError(
                        f"strategy {s!r} does not support queueing policy "
                        f"{q!r}; it supports {strat.queue_policies}")

    def cells(self):
        for load in self.loads:
            for seed in self.seeds:
                for sched in self.schedulers:
                    for strat in self.strategies:
                        yield strat, sched, load, seed

    @property
    def size(self) -> int:
        return (len(self.strategies) * len(self.schedulers)
                * len(self.loads) * len(self.seeds))


@dataclass
class CellResult:
    """One simulated grid cell."""

    strategy: str
    scheduler: str
    load: float
    seed: int
    report: MetricsReport
    wall_time: float            # seconds spent simulating this cell

    def key(self) -> Tuple[str, str, float]:
        return (self.strategy, self.scheduler, self.load)


#: stable column order of :meth:`CampaignResult.aggregate` rows — the
#: contract tabular consumers (CSV export, :mod:`repro_torch.core.figures`)
#: rely on; append-only across PRs
AGGREGATE_COLUMNS: Tuple[str, ...] = (
    "strategy", "scheduler", "load", "seeds", "n_finished",
    "jct_mean", "jct_p99", "queue_delay_mean", "queue_delay_p99",
    "makespan_mean", "contention_ratio_mean", "frag_gpu", "frag_network",
    "preemptions", "failures", "resizes", "migrations", "migration_bytes",
    "goodput_mean", "frag_index_mean", "sim_seconds")


@dataclass
class CampaignResult:
    spec: ClusterSpec
    grid: CampaignGrid
    cells: List[CellResult] = field(default_factory=list)
    # one stats entry per simulated trace, keyed "load=<λ>,seed=<s>"
    trace_info: Dict[str, Dict[str, float]] = field(default_factory=dict)
    wall_time: float = 0.0
    # fault accounting (repro_torch.core.runtime): cells quarantined after
    # exhausting retries, and how many cells were loaded from a resume
    # journal instead of simulated
    failed_cells: List[FailedCell] = field(default_factory=list)
    resumed_cells: int = 0
    # wall seconds the journal spent serialising + flushing cell records
    # (0.0 when the campaign ran without one) — the bench overhead gate
    # reads this instead of differencing two noisy end-to-end timings
    journal_seconds: float = 0.0

    # -- completeness -------------------------------------------------------
    def missing_cells(self) -> List[Tuple[str, str, float, int]]:
        """Grid cells with no result — quarantined or never run.  Partial
        consumers (figures, reports) must surface these, not paper over
        them (docs/robustness.md)."""
        have = {(c.strategy, c.scheduler, c.load, c.seed)
                for c in self.cells}
        return [k for k in self.grid.cells() if k not in have]

    @property
    def complete(self) -> bool:
        """True when every grid cell has a result."""
        return not self.missing_cells()

    # -- aggregation --------------------------------------------------------
    def aggregate(self) -> List[Dict[str, float]]:
        """One row per (strategy, scheduler, load), pooled across seeds:
        JCT mean/p99, queueing delay (JWT) mean/p99, makespan, contention
        ratio mean, fragmentation counts.

        Over condensed (streaming) cells the means come from the exact
        per-cell scalars weighted by finished-job counts; the percentiles
        pool the retained order statistics (approximate, bounded error)."""
        groups: Dict[Tuple[str, str, float], List[CellResult]] = {}
        for c in self.cells:
            groups.setdefault(c.key(), []).append(c)
        rows = []
        for (strat, sched, load), cells in sorted(groups.items()):
            # pool only real samples — a cell that finished nothing adds no
            # phantom 0.0; a fully-empty group reports 0.0 with n_finished=0
            jcts = np.asarray([s for c in cells for s in c.report.jcts]
                              or [0.0])
            jwts = np.asarray([s for c in cells for s in c.report.jwts]
                              or [0.0])
            slow = [s for c in cells for s in c.report.slowdowns]
            n_tot = sum(c.report.n_finished for c in cells)
            if any(c.report.condensed for c in cells) and n_tot:
                jct_mean = sum(c.report.avg_jct * c.report.n_finished
                               for c in cells) / n_tot
                jwt_mean = sum(c.report.avg_jwt * c.report.n_finished
                               for c in cells) / n_tot
                # a mixed group can hold full cells too: their slowdown
                # stats come straight from the raw samples
                pairs = [(c.report.slowdown_mean, c.report.n_slowdowns)
                         if c.report.condensed else
                         (float(np.mean(c.report.slowdowns))
                          if c.report.slowdowns else 0.0,
                          len(c.report.slowdowns))
                         for c in cells]
                n_slow = sum(n for _, n in pairs)
                slow_mean = (sum(m * n for m, n in pairs) / n_slow
                             if n_slow else 1.0)
            else:
                jct_mean = float(jcts.mean())
                jwt_mean = float(jwts.mean())
                slow_mean = float(np.mean(slow)) if slow else 1.0
            frag_vals = [f for c in cells for _, f in c.report.frag_series]
            rows.append({
                "strategy": strat, "scheduler": sched, "load": load,
                "seeds": len(cells),
                "n_finished": n_tot,
                "jct_mean": jct_mean,
                "jct_p99": float(np.percentile(jcts, 99)),
                "queue_delay_mean": jwt_mean,
                "queue_delay_p99": float(np.percentile(jwts, 99)),
                "makespan_mean": float(np.mean([c.report.makespan
                                                for c in cells])),
                "contention_ratio_mean": slow_mean,
                "frag_gpu": sum(c.report.frag_gpu for c in cells),
                "frag_network": sum(c.report.frag_network for c in cells),
                # dynamic-events columns (all 0 for churn-free campaigns)
                "preemptions": sum(c.report.preemptions for c in cells),
                "failures": sum(c.report.failures for c in cells),
                "resizes": sum(c.report.resizes for c in cells),
                "migrations": sum(c.report.migrations for c in cells),
                "migration_bytes": float(sum(c.report.migration_bytes
                                             for c in cells)),
                "goodput_mean": float(np.mean([c.report.goodput
                                               for c in cells])),
                "frag_index_mean": (float(np.mean(frag_vals))
                                    if frag_vals else 0.0),
                "sim_seconds": float(sum(c.wall_time for c in cells)),
            })
        return rows

    def _pooled_cdf(self, attr: str, strategy: str,
                    scheduler: Optional[str], load: Optional[float],
                    num_points: int) -> List[List[float]]:
        samples = [s for c in self.cells
                   if c.strategy == strategy
                   and (scheduler is None or c.scheduler == scheduler)
                   and (load is None or c.load == load)
                   for s in getattr(c.report, attr)]
        return cdf(samples, num_points)

    def contention_cdf(self, strategy: str, scheduler: Optional[str] = None,
                       load: Optional[float] = None,
                       num_points: int = 50) -> List[List[float]]:
        """Pooled contention-ratio (JRT / ideal JRT) CDF for one strategy,
        optionally restricted to a scheduler / load slice."""
        return self._pooled_cdf("slowdowns", strategy, scheduler, load,
                                num_points)

    def jct_cdf(self, strategy: str, scheduler: Optional[str] = None,
                load: Optional[float] = None,
                num_points: int = 50) -> List[List[float]]:
        return self._pooled_cdf("jcts", strategy, scheduler, load,
                                num_points)

    def to_table(self, columns: Optional[Sequence[str]] = None,
                 ) -> Tuple[Tuple[str, ...], List[Tuple]]:
        """The :meth:`aggregate` rows as ``(columns, rows)`` with a stable,
        explicit column order (default :data:`AGGREGATE_COLUMNS`) — the
        tabular export figure specs and CSV writers build on.  Unknown
        column names raise instead of emitting ragged rows."""
        cols = tuple(columns) if columns is not None else AGGREGATE_COLUMNS
        rows = self.aggregate()
        for c in cols:
            if rows and c not in rows[0]:
                raise KeyError(f"unknown campaign column {c!r}; "
                               f"choose from {AGGREGATE_COLUMNS}")
        return cols, [tuple(r[c] for c in cols) for r in rows]

    def write_csv(self, path: str,
                  columns: Optional[Sequence[str]] = None) -> None:
        """Write the aggregate table as CSV in stable column order
        (atomically: a crash mid-write never leaves a truncated file)."""
        import csv as _csv
        import io as _io
        cols, rows = self.to_table(columns)
        buf = _io.StringIO()
        w = _csv.writer(buf)
        w.writerow(cols)
        w.writerows(rows)
        atomic_write_text(path, buf.getvalue())

    # -- serialisation ------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "cluster": {"num_gpus": self.spec.num_gpus,
                        "num_leafs": self.spec.num_leafs,
                        "num_spines": self.spec.num_spines,
                        "num_ocs": self.spec.num_ocs},
            "grid": dataclasses.asdict(self.grid),
            "trace": self.trace_info,
            "wall_time": self.wall_time,
            "table": self.aggregate(),
            "contention_cdfs": {s: self.contention_cdf(s)
                                for s in self.grid.strategies},
            "jct_cdfs": {s: self.jct_cdf(s) for s in self.grid.strategies},
            "failed_cells": [dataclasses.asdict(f)
                             for f in self.failed_cells],
            "missing_cells": [list(k) for k in self.missing_cells()],
            "resumed_cells": self.resumed_cells,
        }

    def save(self, path: str) -> None:
        atomic_write_text(path, json.dumps(self.to_json(), indent=1,
                                           sort_keys=True))


def _run_cell(spec: ClusterSpec, trace: List[Job], config: SimConfig,
              cell_index: int = -1, attempt: int = 0, device: str = "cuda",
              ) -> Tuple[MetricsReport, float]:
    """One grid cell — top-level so ``ProcessPoolExecutor`` can pickle it.
    ``config`` is already cell-resolved in the parent: the strategy
    travels by registry name (never as an instance, which might not
    pickle) and is re-resolved against the registry inside the worker.
    Streaming cells condense inside the worker, so only O(max_samples)
    floats cross the process boundary (and stay resident in the parent).

    ``cell_index``/``attempt`` identify the call for the deterministic
    fault-injection harness (:mod:`repro_torch.testing.chaos`) — inert (one env
    lookup) unless ``REPRO_CHAOS`` is set.  ``device`` (a string, so it
    pickles) is where the cell's rate resolution runs."""
    if os.environ.get("REPRO_CHAOS"):
        from ..testing.chaos import chaos_hook
        chaos_hook(cell_index, attempt)
    t0 = time.time()
    rep = simulate(spec, trace, config=config, device=device)
    dt = time.time() - t0
    if config.store == "stream":
        rep.condense()
    return rep, dt


def run_campaign(spec: ClusterSpec, grid: CampaignGrid,
                 workload: Optional[WorkloadSpec] = None,
                 trace: Optional[Sequence[Job]] = None,
                 incremental: Optional[bool] = None,
                 engine: Optional[str] = None,
                 workers: Optional[int] = None,
                 store: Optional[str] = None,
                 ilp_time_limit: Optional[float] = None,
                 ocs_spec: Optional[ClusterSpec] = None,
                 progress: Optional[Callable[[str], None]] = None,
                 config: Optional[SimConfig] = None,
                 cell_timeout: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 quarantine: Optional[bool] = None,
                 journal: Optional[str] = None,
                 resume: Optional[str] = None,
                 device: str = "cuda",
                 ) -> CampaignResult:
    """Sweep every grid cell over a shared trace and aggregate the metrics.

    Traces are regenerated per (load, seed) from ``workload`` — strategies
    and schedulers within a (load, seed) slice always see the identical job
    list, so their columns are directly comparable. When an explicit
    ``trace`` is passed instead, the ``loads`` axis must be a single entry
    (the trace fixes the arrival process) and seeds only vary the
    simulator's internal randomness (ECMP hashing, relaxed placement).

    ``engine`` — simulator engine per cell (``"v2"`` heap engine default,
    ``"v1"`` scan engine, ``"batched"`` lane engine — serial campaigns
    run all qualifying cells in lockstep, see docs/batched.md); all
    produce bit-identical schedules.

    ``workers`` — when > 1, shard grid cells across a
    ``ProcessPoolExecutor``.  Results are merged in grid order regardless
    of completion order and every cell's trace/seed is fixed up front, so
    a parallel campaign is bit-identical to the serial one.

    ``store`` — ``"full"`` keeps every per-job sample; ``"stream"``
    condenses each cell to bounded-size order statistics
    (:meth:`repro_torch.core.metrics.MetricsReport.condense`) so 10k-job
    campaigns hold O(512) floats per cell.

    ``ocs_spec`` — cluster used for cells whose strategy asks for it
    (``Strategy.wants_ocs_spec``: ``ocs-vclos`` / ``ocs-relax``; defaults
    to ``spec`` — pass the ``*_OCS`` preset so those strategies have
    circuits to rewire).

    ``config`` — a :class:`repro_torch.core.config.SimConfig` carrying the
    engine/incremental/workers/store/ilp_time_limit knobs in one object
    (its per-cell fields — strategy, scheduler, seed — are overridden by
    the grid).  Loose kwargs explicitly passed alongside it override the
    matching config fields; omitted ones keep the config's values.

    ``cell_timeout`` / ``max_retries`` / ``quarantine`` — fault policy
    (see :class:`repro_torch.core.config.SimConfig` and
    :mod:`repro_torch.core.runtime`).  A ``cell_timeout > 0`` forces pool
    execution even at ``workers=1`` (a hung in-process cell cannot be
    killed).

    ``journal`` — path to write an append-only cell journal: every
    completed cell is persisted the moment it finishes, so a crashed or
    interrupted campaign loses at most the in-flight cells.  ``resume`` —
    path of an existing journal to continue: journaled cells are loaded
    instead of re-simulated (after a schema check that the journal
    matches this campaign's grid/cluster/traces/config) and new
    completions keep appending to it.  The merged result is
    **bit-identical** to an uninterrupted run (``tests/test_runtime.py``).

    ``device`` — where every cell's rate resolution runs: ``"cuda"``
    (default; raises where there is no card) or ``"cpu"``.  It is not part
    of the journal schema: schedules are identical on both, so a journal
    written on one resumes on the other.  On ``cuda`` the segment-max
    library is built (or loaded) here before any pool starts, so spawned
    workers only load it.
    """
    return _execute(_prepare(
        spec, grid, workload=workload, trace=trace, incremental=incremental,
        engine=engine, workers=workers, store=store,
        ilp_time_limit=ilp_time_limit, ocs_spec=ocs_spec, progress=progress,
        config=config, cell_timeout=cell_timeout, max_retries=max_retries,
        quarantine=quarantine, journal=journal, resume=resume,
        device=device))


class _Prepared(NamedTuple):
    """A campaign whose cells are resolved and whose journal is open (or
    resumed), ready for :func:`_execute`."""

    result: CampaignResult
    cells: List[CampaignCell]
    config: SimConfig
    journal: Optional[CellJournal]
    outcomes: Dict[int, CellOutcome]
    progress: Optional[Callable[[str], None]]
    device: str
    t0: float


def _prepare(spec: ClusterSpec, grid: CampaignGrid, *, workload, trace,
             incremental, engine, workers, store, ilp_time_limit, ocs_spec,
             progress, config, cell_timeout, max_retries, quarantine,
             journal, resume, device) -> _Prepared:
    """:func:`run_campaign` up to the first cell: validation, the traces
    and events of every slice, the per-cell configs and the journal (a
    resume that does not match raises :class:`JournalMismatch` here,
    before anything runs)."""
    device = str(resolve_device(device))
    config = (config or SimConfig()).with_overrides(
        incremental=incremental, engine=engine, workers=workers,
        store=store, ilp_time_limit=ilp_time_limit,
        cell_timeout=cell_timeout, max_retries=max_retries,
        quarantine=quarantine)
    if journal is not None and resume is not None and journal != resume:
        raise ValueError(
            "pass either journal= (start a fresh journal) or resume= "
            "(continue an existing one), not two different paths")
    if trace is not None and len(grid.loads) > 1:
        raise ValueError("an explicit trace fixes the arrival process; "
                         "use a single-entry loads axis")
    needs_ocs = [s for s in grid.strategies if get_strategy(s).requires_ocs]
    if needs_ocs:
        eff = ocs_spec if ocs_spec is not None else spec
        if not eff.num_ocs:
            raise ValueError(
                f"{needs_ocs[0]} needs an OCS-equipped cluster: pass "
                f"ocs_spec= (e.g. CLUSTER512_OCS) or a spec with "
                f"num_ocs > 0")
    if trace is not None:
        uses_ocs_spec = (ocs_spec is not None and
                         any(get_strategy(s).wants_ocs_spec
                             for s in grid.strategies))
        limit = min([spec.num_gpus]
                    + ([ocs_spec.num_gpus] if uses_ocs_spec else []))
        for j in trace:
            if j.num_gpus > limit:
                raise ValueError(
                    f"trace job {j.job_id} wants {j.num_gpus} GPUs but the "
                    f"cluster has {limit}; it could never be placed and "
                    f"would starve FIFO campaigns")
    if workload is None:
        workload = WorkloadSpec(num_jobs=500, max_gpus=spec.num_gpus)
    result = CampaignResult(spec=spec, grid=grid)
    t0 = time.time()
    traces: Dict[Tuple[float, int], List[Job]] = {}
    events: Dict[Tuple[float, int], tuple] = {}
    cells: List[CampaignCell] = []
    for strat, sched, load, seed in grid.cells():
        tkey = (load, seed)
        if tkey not in traces:
            traces[tkey] = (list(trace) if trace is not None else
                            generate_trace(workload.with_load(load).with_seed(seed)))
            result.trace_info[f"load={load:g},seed={seed}"] = \
                trace_stats(traces[tkey])
            # churn events regenerate per (load, seed) exactly like the
            # trace, so every strategy/scheduler cell of a slice replays
            # the identical event sequence (paired churn ablations); a
            # caller-supplied config.events list is shared by every cell
            # and concatenated in front (the simulator time-sorts)
            cell_events = (generate_events(
                workload.with_load(load).with_seed(seed), traces[tkey],
                spec) if workload.has_churn and trace is None else [])
            events[tkey] = tuple(config.events) + tuple(cell_events)
        cell_spec = ocs_spec if (ocs_spec is not None and
                                 get_strategy(strat).wants_ocs_spec) else spec
        # resolve the per-cell config here in the parent: the grid's name
        # replaces whatever config.strategy held (possibly an unpicklable
        # Strategy instance), so workers always receive plain scalars
        cell_cfg = dataclasses.replace(config, strategy=strat,
                                       scheduler=sched, seed=seed,
                                       events=events[tkey])
        cells.append(CampaignCell(strat, sched, load, seed, cell_spec,
                                  traces[tkey], cell_cfg))

    # -- journal / resume ---------------------------------------------------
    schema = journal_schema(spec, ocs_spec, grid, config, cells)
    jr: Optional[CellJournal] = None
    outcomes: Dict[int, CellOutcome] = {}
    if resume is not None:
        jr, loaded = CellJournal.resume(resume, schema)
        for i, cell in enumerate(cells):
            hit = loaded.get(cell.key())
            if hit is not None:
                rep, dt = hit
                outcomes[i] = CellOutcome(rep, dt, attempts=0, resumed=True)
        if progress is not None and outcomes:
            progress(f"[campaign] resumed {len(outcomes)}/{len(cells)} "
                     f"cells from {resume}")
    elif journal is not None:
        jr = CellJournal.create(journal, schema)
    return _Prepared(result, cells, config, jr, outcomes, progress, device,
                     t0)


def _execute(prep: _Prepared) -> CampaignResult:
    """Run the pending cells of a prepared campaign and merge its result
    in grid order; the journal is closed whatever happens."""
    result, cells, config, jr, outcomes, progress, device, t0 = prep
    pending = [i for i in range(len(cells)) if i not in outcomes]
    runner = CellRunner(cells, config,
                        run_cell=functools.partial(_run_cell, device=device),
                        journal=jr, progress=progress)
    failed: Dict[int, FailedCell] = {}
    with contextlib.ExitStack() as stack:
        if jr is not None:
            stack.callback(_close_journal, jr, result)
        # pool execution when sharding across workers, and whenever a
        # cell_timeout is set (a hung in-process cell cannot be killed)
        if (config.workers and config.workers > 1) \
                or config.cell_timeout > 0:
            if device.startswith("cuda") and pending:
                from ..kernels.build import library
                library("phase_max")
            res, fl = runner.run_pool(pending)
        else:
            # serial campaigns under engine="batched" run every qualifying
            # pending cell as one lane group in lockstep (grouped per
            # cluster spec); non-qualifying cells fall through to per-cell
            # simulate().  The group's wall time is split evenly across
            # its cells, so sim_seconds stays comparable with per-cell
            # engines.
            done: Dict[int, CellOutcome] = {}
            if config.engine == "batched":
                from .batched import config_qualifies, run_lanes
                groups: Dict[int, Tuple[ClusterSpec, List[int]]] = {}
                for i in pending:
                    # hetero specs never lane-batch: speed-aware rate
                    # resolution lives in v1/v2 (docs/heterogeneous.md)
                    if not cells[i].spec.is_hetero \
                            and config_qualifies(cells[i].config):
                        groups.setdefault(id(cells[i].spec),
                                          (cells[i].spec, []))[1].append(i)
                for cell_spec, idxs in groups.values():
                    lanes_in = []
                    for i in idxs:
                        cell = cells[i]
                        lane_jobs = [_copy.copy(j) for j in cell.trace]
                        for j in lane_jobs:   # same reset as simulate()
                            j.start_time = None
                            j.finish_time = None
                            j.remaining_iters = None
                        lanes_in.append((lane_jobs,
                                         cell.config.resolve_strategy(),
                                         cell.seed))
                    tg = time.time()
                    reps = run_lanes(cell_spec, lanes_in, device=device)
                    dt = (time.time() - tg) / len(idxs)
                    for i, rep in zip(idxs, reps):
                        if cells[i].config.store == "stream":
                            rep.condense()
                        runner._complete(i, rep, dt, 1, done)
            res, fl = runner.run_serial([i for i in pending
                                         if i not in done])
            res.update(done)
        outcomes.update(res)
        failed.update(fl)

    # merge in grid order: deterministic regardless of completion order,
    # worker count, or how many cells came from the journal
    for i, cell in enumerate(cells):
        out = outcomes.get(i)
        if out is None:
            continue        # quarantined — accounted in failed_cells
        result.cells.append(CellResult(cell.strategy, cell.scheduler,
                                       cell.load, cell.seed, out.report,
                                       out.wall_time))
        if out.resumed:
            result.resumed_cells += 1
    result.failed_cells = [failed[i] for i in sorted(failed)]
    result.wall_time = time.time() - t0
    return result


def _close_journal(jr: CellJournal, result: CampaignResult) -> None:
    result.journal_seconds = jr.io_seconds
    jr.close()


def run_windowed_campaign(spec: ClusterSpec, grid: CampaignGrid,
                          source: "TraceSource | str",
                          window_jobs: int,
                          stride_jobs: Optional[int] = None,
                          max_windows: Optional[int] = None,
                          *,
                          engine: Optional[str] = None,
                          workers: Optional[int] = None,
                          store: Optional[str] = None,
                          ocs_spec: Optional[ClusterSpec] = None,
                          progress: Optional[Callable[[str], None]] = None,
                          config: Optional[SimConfig] = None,
                          device: str = "cuda",
                          ) -> CampaignResult:
    """Replay a long (possibly million-job) trace as overlapping windows.

    The trace streams through :meth:`repro_torch.core.traces.TraceSource.iter_jobs`
    and :func:`repro_torch.core.traces.iter_windows` — at no point is the whole
    job list resident; memory is bounded by the reorder buffer plus the
    open windows (≤ ``ceil(window_jobs / stride_jobs)`` buffers of
    ``window_jobs`` jobs).  Each window becomes one ``seeds``-axis slice of
    the merged :class:`CampaignResult`: the grid's seeds axis is
    **repurposed as the window index** (arrivals are rebased to 0 per
    window, so windows are exchangeable replicas of the arrival process),
    which makes :meth:`CampaignResult.aggregate` pool across windows
    exactly as it pools across seeds.  Cells default to ``store="stream"``
    so per-window metrics condense to bounded order statistics.

    ``source`` — a :class:`repro_torch.core.traces.TraceSource` or a path
    (format auto-detected).  ``grid`` must have single-entry ``loads`` and
    ``seeds`` axes (the trace fixes the arrival process; windows take over
    the seeds axis).  ``max_windows`` stops consuming the stream once the
    requested windows closed — on a 1M-job trace with ``max_windows=10``
    the reader never materialises more than the windowed span.
    ``device`` — as :func:`run_campaign`'s, for every window.
    """
    from .traces import TraceSource, iter_windows
    device = str(resolve_device(device))
    if isinstance(source, (str, os.PathLike)):
        source = TraceSource(str(source))
    if len(grid.loads) > 1:
        raise ValueError("a trace fixes the arrival process; use a "
                         "single-entry loads axis")
    if len(grid.seeds) != 1:
        raise ValueError(
            "windowed campaigns repurpose the seeds axis as the window "
            "index; pass a single-entry seeds axis")
    if store is None:
        store = "stream" if config is None else None
    t0 = time.time()
    result = CampaignResult(spec=spec, grid=grid)
    indices: List[int] = []
    for win in iter_windows(source.iter_jobs(), window_jobs, stride_jobs,
                            max_windows):
        if progress is not None:
            progress(f"[windowed] window {win.index}: {len(win.jobs)} jobs "
                     f"from trace index {win.start} (t0={win.t0:g})")
        wgrid = dataclasses.replace(grid, seeds=(win.index,))
        wres = run_campaign(spec, wgrid, trace=list(win.jobs),
                            engine=engine, workers=workers, store=store,
                            ocs_spec=ocs_spec, progress=progress,
                            config=config, device=device)
        indices.append(win.index)
        result.cells.extend(wres.cells)
        result.failed_cells.extend(wres.failed_cells)
        result.resumed_cells += wres.resumed_cells
        for key, stats in wres.trace_info.items():
            result.trace_info[f"window={win.index},{key}"] = stats
    if not indices:
        raise ValueError(
            f"trace {source.path} produced no windows (is it empty?)")
    # the merged grid's seeds axis records which windows actually ran, so
    # missing_cells() stays honest for partial consumers
    result.grid = dataclasses.replace(grid, seeds=tuple(indices))
    result.wall_time = time.time() - t0
    return result
