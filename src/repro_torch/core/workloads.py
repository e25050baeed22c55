"""Reproducible workload traces for simulation campaigns (§9.2, §9.8).

The paper's large-scale evidence (Tables 5-7, Fig. 12/13) is trace-driven:
Poisson job arrivals over empirical GPU-size mixes (Helios for CLUSTER512/
2048, the TPUv4-style large-job mix of Table 7) with heavy-tailed durations.
This module makes those traces first-class objects:

  * :class:`WorkloadSpec` — a frozen, hashable description of a synthetic
    trace (arrival process, size mix, model mix, duration distribution,
    deadline slack). Same spec + same seed ⇒ bit-identical job list.
  * :func:`generate_trace` / :func:`poisson_trace` — spec → ``List[Job]``.
  * :func:`trace_stats` — arrival-rate / load sanity summary of a trace.
  * :func:`save_trace_csv` / :func:`load_trace_csv` — external traces
    round-trip through a plain CSV schema, so production traces (or traces
    exported from other simulators, e.g. CASSINI-style workloads) can be
    replayed against every strategy.

The generator intentionally mirrors :func:`repro_torch.core.jobs.cluster_dataset`'s
draw order so ``generate_trace(WorkloadSpec(...))`` reproduces the historical
datasets when given matching parameters.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .events import ClusterEvent
from .jobs import (BATCHES, HELIOS_SIZE_MIX, PROFILES, TPUV4_SIZE_MIX, Job,
                   weighted_choice)
from .topology import ClusterSpec

SizeMix = Sequence[Tuple[int, float]]

#: Named empirical GPU-size mixes. "helios" is the §9.2 CLUSTER512/2048
#: dataset; "tpuv4" is Table 7's large-job mix; "testbed" matches the §8.1
#: 32-GPU testbed job sizes.
SIZE_MIXES: Dict[str, SizeMix] = {
    "helios": HELIOS_SIZE_MIX,
    "tpuv4": TPUV4_SIZE_MIX,
    "testbed": [(2, 0.3), (4, 0.3), (8, 0.25), (16, 0.15)],
}

ALLREDUCE_ALGOS = ("ring", "hierarchical_ring", "hd")


@dataclass(frozen=True)
class WorkloadSpec:
    """Declarative description of a synthetic Poisson job trace.

    ``mean_interarrival`` is the paper's λ (seconds between arrivals);
    smaller λ ⇒ higher offered load. ``deadline_slack`` — when set to a
    ``(lo, hi)`` pair — assigns each job a deadline of
    ``arrival + ideal_runtime * U(lo, hi)`` for EDF experiments (§9.7).
    """

    num_jobs: int = 1000
    mean_interarrival: float = 120.0
    size_mix: Union[str, Tuple[Tuple[int, float], ...]] = "helios"
    models: Tuple[str, ...] = tuple(PROFILES)
    iters_log_mean: float = 8.8
    iters_log_sigma: float = 1.1
    min_iters: int = 50
    max_gpus: Optional[int] = None
    deadline_slack: Optional[Tuple[float, float]] = None
    seed: int = 0
    # -- dynamic-cluster churn (consumed by generate_events, NOT by
    # generate_trace: the job trace for a given seed is identical with or
    # without churn, so churn sweeps are paired-sample ablations) ----------
    #: fraction of jobs hit by one mid-run `preempt` event
    preempt_fraction: float = 0.0
    #: fraction of jobs hit by one elastic `resize` (×2 grow or ÷2 shrink)
    resize_fraction: float = 0.0
    #: mean time between server failures (seconds); None/0 disables
    server_mtbf: Optional[float] = None
    #: mean time between single-link failures (seconds); None/0 disables
    link_mtbf: Optional[float] = None
    #: outage length of one failure (seconds)
    fail_duration: float = 1800.0
    #: checkpoint-restart cost charged to every killed/preempted job, in
    #: iterations of redone work
    restart_iters: float = 50.0

    @property
    def has_churn(self) -> bool:
        return bool(self.preempt_fraction or self.resize_fraction
                    or self.server_mtbf or self.link_mtbf)

    def resolve_mix(self) -> SizeMix:
        if isinstance(self.size_mix, str):
            if self.size_mix not in SIZE_MIXES:
                raise ValueError(
                    f"unknown size mix {self.size_mix!r}; "
                    f"choose from {sorted(SIZE_MIXES)}")
            return SIZE_MIXES[self.size_mix]
        return list(self.size_mix)

    def with_load(self, mean_interarrival: float) -> "WorkloadSpec":
        return dataclasses.replace(self, mean_interarrival=mean_interarrival)

    def with_seed(self, seed: int) -> "WorkloadSpec":
        return dataclasses.replace(self, seed=seed)


def generate_trace(spec: WorkloadSpec) -> List[Job]:
    """Materialise ``spec`` into a job list. Deterministic in ``spec.seed``."""
    rng = np.random.default_rng(spec.seed)
    mix = spec.resolve_mix()
    sizes = [s for s, _ in mix]
    probs = [p for _, p in mix]
    models = list(spec.models)
    jobs: List[Job] = []
    t = 0.0
    for i in range(spec.num_jobs):
        n = int(weighted_choice(rng, sizes, probs))
        if spec.max_gpus:
            n = min(n, spec.max_gpus)
        model = models[rng.integers(len(models))]
        batch = int(BATCHES[model][rng.integers(len(BATCHES[model]))])
        algo = ALLREDUCE_ALGOS[rng.integers(len(ALLREDUCE_ALGOS))]
        iters = int(rng.lognormal(mean=spec.iters_log_mean,
                                  sigma=spec.iters_log_sigma))
        t += rng.exponential(spec.mean_interarrival)
        job = Job(i, model, n, batch, t, max(iters, spec.min_iters),
                  allreduce_algo=algo)
        if spec.deadline_slack is not None:
            lo, hi = spec.deadline_slack
            job.deadline = t + job.ideal_runtime() * float(rng.uniform(lo, hi))
        jobs.append(job)
    return jobs


def poisson_trace(num_jobs: int = 1000, mean_interarrival: float = 120.0,
                  size_mix: Union[str, SizeMix] = "helios", seed: int = 0,
                  **kwargs) -> List[Job]:
    """Convenience wrapper: ``generate_trace(WorkloadSpec(...))``."""
    if not isinstance(size_mix, str):
        size_mix = tuple((int(s), float(p)) for s, p in size_mix)
    return generate_trace(WorkloadSpec(num_jobs=num_jobs,
                                 mean_interarrival=mean_interarrival,
                                 size_mix=size_mix, seed=seed, **kwargs))


# ---------------------------------------------------------------------------
# Dynamic-event traces (repro_torch.core.events)
# ---------------------------------------------------------------------------

def generate_events(spec: WorkloadSpec, jobs: Sequence[Job],
                    cluster: ClusterSpec) -> List[ClusterEvent]:
    """Materialise ``spec``'s churn fields into a sorted event trace for
    ``jobs`` on ``cluster``.  Deterministic in ``spec.seed`` — and drawn
    from a *separate* RNG stream, so the job trace of
    :func:`generate_trace` is untouched by churn parameters (golden JCTs
    survive; churn ablations stay paired).

    Per-job events (preempt/resize) land at ``arrival + U(0.25, 1.25) ×
    ideal_runtime`` — mostly mid-run, sometimes after a short job already
    finished (a no-op, like real preemption races).  Failures are Poisson
    arrivals over 1.25× the arrival span plus one outage; overlapping
    failures of the same resource are dropped so every ``*-fail`` pairs
    with exactly one ``*-recover`` ``fail_duration`` later.
    """
    rng = np.random.default_rng([spec.seed, 0xD1CE])
    events: List[ClusterEvent] = []
    if not jobs:
        return events
    for j in jobs:
        if spec.preempt_fraction and rng.random() < spec.preempt_fraction:
            t = j.arrival + float(rng.uniform(0.25, 1.25)) * j.ideal_runtime()
            events.append(ClusterEvent(time=t, kind="preempt",
                                       job_id=j.job_id,
                                       restart_iters=spec.restart_iters))
        if spec.resize_fraction and rng.random() < spec.resize_fraction:
            t = j.arrival + float(rng.uniform(0.25, 1.25)) * j.ideal_runtime()
            new = (j.num_gpus * 2 if rng.random() < 0.5
                   else max(1, j.num_gpus // 2))
            events.append(ClusterEvent(time=t, kind="resize",
                                       job_id=j.job_id,
                                       new_gpus=min(new, cluster.num_gpus),
                                       restart_iters=spec.restart_iters))
    horizon = max(j.arrival for j in jobs) * 1.25 + spec.fail_duration
    if spec.server_mtbf:
        busy: Dict[int, float] = {}       # server -> down-until

        t = float(rng.exponential(spec.server_mtbf))
        while t < horizon:
            sv = int(rng.integers(cluster.num_servers))
            if busy.get(sv, -1.0) < t:
                busy[sv] = t + spec.fail_duration
                events.append(ClusterEvent(
                    time=t, kind="server-fail", server=sv,
                    restart_iters=spec.restart_iters))
                events.append(ClusterEvent(
                    time=t + spec.fail_duration, kind="server-recover",
                    server=sv))
            t += float(rng.exponential(spec.server_mtbf))
    if spec.link_mtbf:
        busy_l: Dict[Tuple[int, int], float] = {}
        t = float(rng.exponential(spec.link_mtbf))
        while t < horizon:
            n = int(rng.integers(cluster.num_leafs))
            m = int(rng.integers(cluster.num_spines))
            if busy_l.get((n, m), -1.0) < t:
                busy_l[(n, m)] = t + spec.fail_duration
                events.append(ClusterEvent(
                    time=t, kind="link-fail", leaf=n, spine=m,
                    restart_iters=spec.restart_iters))
                events.append(ClusterEvent(
                    time=t + spec.fail_duration, kind="link-recover",
                    leaf=n, spine=m))
            t += float(rng.exponential(spec.link_mtbf))
    events.sort(key=lambda e: e.time)
    return events


# ---------------------------------------------------------------------------
# Trace sanity
# ---------------------------------------------------------------------------

def trace_stats(jobs: Sequence[Job]) -> Dict[str, float]:
    """Arrival-rate / demand summary used by tests and campaign logs.

    ``arrival_rate`` is ``(n - 1) / span`` — jobs per second over the
    observed arrival span.  A zero-length span (a single job, or a
    coarse-timestamp trace where every arrival ties) carries no rate
    information, so it reports **0.0** — the same value the single-job
    path reports — never ``inf``: downstream λ estimates
    (``1 / arrival_rate`` guards aside) and JSON serialisation both
    choke on infinities."""
    if not jobs:
        return {"n": 0, "arrival_rate": 0.0, "mean_interarrival": 0.0,
                "mean_gpus": 0.0, "gpu_seconds": 0.0}
    arrivals = sorted(j.arrival for j in jobs)
    span = arrivals[-1] - arrivals[0]
    gaps = np.diff(arrivals)
    return {
        "n": len(jobs),
        "arrival_rate": (len(jobs) - 1) / span if span > 0 else 0.0,
        "mean_interarrival": float(gaps.mean()) if len(gaps) else 0.0,
        "mean_gpus": float(np.mean([j.num_gpus for j in jobs])),
        "gpu_seconds": float(sum(j.num_gpus * j.ideal_runtime()
                                 for j in jobs)),
    }


# ---------------------------------------------------------------------------
# CSV trace round-trip
# ---------------------------------------------------------------------------

TRACE_FIELDS = ("job_id", "model", "num_gpus", "batch_size", "arrival",
                "num_iters", "allreduce_algo", "deadline")

_DIGITS = r"\d(?:_?\d)*"
#: exactly the strings ``float()`` accepts once stripped: Python's
#: ``floatvalue`` grammar (Unicode decimal digits, ``_`` between digits,
#: ``inf`` / ``infinity`` / ``nan`` in any case, an optional sign)
_FLOAT_LITERAL = re.compile(
    rf"[+-]?(?:(?:(?:{_DIGITS})?\.{_DIGITS}|{_DIGITS}\.?)"
    rf"(?:[eE][+-]?{_DIGITS})?|inf|infinity|nan)", re.IGNORECASE)


def is_float_literal(raw: str) -> bool:
    """Whether ``float(raw)`` parses ``raw`` (surrounding whitespace
    allowed, as ``float`` allows it): the check the port makes before each
    conversion of a trace cell, where the reference catches the
    ``ValueError``."""
    return _FLOAT_LITERAL.fullmatch(raw.strip()) is not None


def save_trace_csv(jobs: Sequence[Job], path: str) -> None:
    """Write an arrival trace as CSV (one row per job, schema
    ``TRACE_FIELDS``; empty ``deadline`` means none)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TRACE_FIELDS)
        for j in jobs:
            w.writerow([j.job_id, j.model, j.num_gpus, j.batch_size,
                        repr(j.arrival), j.num_iters, j.allreduce_algo,
                        "" if j.deadline is None else repr(j.deadline)])


def parse_trace_time(raw: str, field: str, path: str, ln: int,
                     allow_none: bool = False) -> Optional[float]:
    """One timestamp cell → validated float.  Rejects ``nan``/``inf`` and
    negative values: a non-finite arrival poisons the v2 completion heap's
    ``(t_fin, order)`` total order (every comparison against ``nan`` is
    False, so heap invariants silently break) and a negative one would
    predate the simulation clock's origin.  Shared by
    :func:`load_trace_csv` and the :mod:`repro_torch.core.traces` adapters so
    every ingestion path enforces the same contract with the same
    ``trace {path}:{ln}:`` error style."""
    raw = (raw or "").strip()
    if not raw:
        if allow_none:
            return None
        raise ValueError(f"trace {path}:{ln}: empty {field}")
    if not is_float_literal(raw):
        raise ValueError(f"trace {path}:{ln}: {field} {raw!r} is not a "
                         f"number")
    val = float(raw)
    if not math.isfinite(val):
        raise ValueError(f"trace {path}:{ln}: {field} must be finite "
                         f"(got {raw!r}; non-finite values break the "
                         f"completion-heap ordering)")
    if val < 0:
        raise ValueError(f"trace {path}:{ln}: {field} must be >= 0 "
                         f"(got {raw!r})")
    return val


def job_from_trace_row(row: Dict[str, str], path: str, ln: int,
                       seen_ids: set) -> Job:
    """Validate one ``TRACE_FIELDS`` CSV row into a :class:`Job`.

    The single row contract behind :func:`load_trace_csv` and the
    streaming ``csv`` adapter of :mod:`repro_torch.core.traces` — both paths
    produce bit-identical jobs because both call exactly this."""
    if any(row.get(f) is None for f in TRACE_FIELDS):
        short = [f for f in TRACE_FIELDS if row.get(f) is None]
        raise ValueError(f"trace {path}:{ln}: row is missing "
                         f"values for {short}")
    jid = int(row["job_id"])
    if jid in seen_ids:
        raise ValueError(f"trace {path}:{ln}: duplicate job_id {jid}"
                         " (the simulator keys running jobs by id)")
    seen_ids.add(jid)
    model = row["model"]
    if model not in PROFILES:
        raise ValueError(f"trace {path}:{ln}: unknown model {model!r}")
    algo = row["allreduce_algo"] or "ring"
    if algo not in ALLREDUCE_ALGOS:
        raise ValueError(f"trace {path}:{ln}: unknown allreduce "
                         f"algorithm {algo!r}")
    num_gpus = int(row["num_gpus"])
    num_iters = int(row["num_iters"])
    batch_size = int(row["batch_size"])
    if num_gpus < 1:
        raise ValueError(f"trace {path}:{ln}: num_gpus must be "
                         f"positive (got {num_gpus})")
    if num_iters < 1:
        raise ValueError(f"trace {path}:{ln}: num_iters must be "
                         f"positive (got {num_iters})")
    if batch_size < 1:
        raise ValueError(f"trace {path}:{ln}: batch_size must be "
                         f"positive (got {batch_size}; it scales "
                         f"per-iteration compute time)")
    arrival = parse_trace_time(row["arrival"], "arrival", path, ln)
    deadline = parse_trace_time(row["deadline"], "deadline", path, ln,
                                allow_none=True)
    return Job(jid, model, num_gpus, batch_size, arrival, num_iters,
               allreduce_algo=algo, deadline=deadline)


def load_trace_csv(path: str) -> List[Job]:
    """Load an external arrival trace. Validates models/algorithms so typos
    in hand-written traces fail loudly instead of KeyError-ing mid-run.

    Jobs are returned in ``(arrival, job_id)`` order: coarse real-trace
    timestamps (Philly-style minute granularity) produce equal arrivals,
    and a plain arrival sort would leave their relative order to the
    file's row order — the job-id tie-break makes replay deterministic
    regardless of how the trace was written."""
    jobs: List[Job] = []
    seen_ids: set = set()
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        missing = set(TRACE_FIELDS) - set(reader.fieldnames or ())
        if missing:
            raise ValueError(f"trace {path}: missing columns {sorted(missing)}")
        for ln, row in enumerate(reader, start=2):
            jobs.append(job_from_trace_row(row, path, ln, seen_ids))
    jobs.sort(key=lambda j: (j.arrival, j.job_id))
    return jobs
