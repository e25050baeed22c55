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

The generator intentionally mirrors :func:`repro_torch.core.jobs.cluster_dataset`'s
draw order so ``generate_trace(WorkloadSpec(...))`` reproduces the historical
datasets when given matching parameters.
"""

from __future__ import annotations

import dataclasses
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
