"""Cluster performance metrics (paper §9.3): JRT, JWT, JCT, Stability.

Besides the paper's headline averages, :class:`MetricsReport` carries the
per-job arrays (``jcts``, ``jwts``, ``slowdowns``) that the campaign engine
(:mod:`repro_torch.core.campaign`) pools across seeds into mean/p99 tables and
contention-ratio CDFs.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .jobs import Job


@dataclass
class MetricsReport:
    avg_jrt: float
    avg_jwt: float
    avg_jct: float
    stability: float            # mean over groups of std(JCT) — lower is better
    p99_jwt: float
    n_finished: int
    frag_gpu: int = 0           # jobs blocked by GPU shortage (Table 2)
    frag_network: int = 0       # jobs blocked by network fragmentation
    p99_jct: float = 0.0
    makespan: float = 0.0       # last finish − first arrival over finished jobs
    # dynamic-events accounting (repro_torch.core.events): churn applied to the
    # run and the work it displaced.  goodput is useful (first-attempt)
    # GPU-seconds delivered per makespan second — under churn it falls
    # while avg_jct alone can hide the redone work.
    preemptions: int = 0        # running jobs stopped by `preempt` events
    failures: int = 0           # running jobs killed by server/link failures
    resizes: int = 0            # elastic resize events applied
    migrations: int = 0         # jobs moved by the defragmentation pass
    migration_bytes: float = 0.0  # checkpoint bytes moved by migrations
    goodput: float = 0.0
    # per-job samples (finished jobs only), for CDFs / cross-seed pooling
    jcts: List[float] = field(default_factory=list, repr=False)
    jwts: List[float] = field(default_factory=list, repr=False)
    # contention ratio: actual JRT / contention-free JRT (1.0 = isolated);
    # filled by the simulator, empty when the producer doesn't track rates
    slowdowns: List[float] = field(default_factory=list, repr=False)
    # fragmentation index over time: [t, frag_index(state)] sampled at every
    # dynamic event and defrag tick (empty when the run had neither)
    frag_series: List[List[float]] = field(default_factory=list, repr=False)
    # applied-event log (t, kind, a, b, n_affected) — the deterministic
    # -replay fingerprint: bit-identical across engines, worker counts and
    # store modes for a fixed SimConfig.seed
    event_log: List[tuple] = field(default_factory=list, repr=False)
    # streaming-aggregation state (see condense()): when True, the per-job
    # arrays hold ≤ max_samples evenly-spaced order statistics and the exact
    # first moments live in the scalars below
    condensed: bool = False
    slowdown_mean: float = 0.0
    n_slowdowns: int = 0

    def condense(self, max_samples: int = 512) -> "MetricsReport":
        """Bound this report's memory: replace the per-job sample arrays by
        at most ``max_samples`` evenly-spaced order statistics each.

        Exact means survive in the scalar fields (``avg_jct``, ``avg_jwt``,
        ``slowdown_mean``); pooled percentiles over condensed reports are
        approximate (error < 1/max_samples of a quantile step).  The
        campaign engine uses this as its streaming path so 10k-job sweeps
        hold O(max_samples) floats per cell instead of O(jobs)."""
        if self.condensed:
            # idempotent: re-thinning the retained order statistics would
            # silently overwrite the exact scalars with sample estimates
            return self

        def thin(xs: List[float]) -> List[float]:
            if len(xs) <= max_samples:
                return sorted(xs)
            arr = np.sort(np.asarray(xs, dtype=float))
            idx = np.unique(np.linspace(0, len(arr) - 1,
                                        max_samples).astype(int))
            return arr[idx].tolist()

        self.slowdown_mean = (float(np.mean(self.slowdowns))
                              if self.slowdowns else 0.0)
        self.n_slowdowns = len(self.slowdowns)
        self.jcts = thin(self.jcts)
        self.jwts = thin(self.jwts)
        self.slowdowns = thin(self.slowdowns)
        if len(self.frag_series) > max_samples:
            # a time series, not order statistics: keep evenly-spaced rows
            # in time order (first/last retained)
            idx = np.unique(np.linspace(0, len(self.frag_series) - 1,
                                        max_samples).astype(int))
            self.frag_series = [self.frag_series[i] for i in idx]
        # event_log stays exact: it is the deterministic-replay fingerprint
        # and is already bounded by the (small) event count
        self.condensed = True
        return self

    # -- journal round-trip (repro_torch.core.runtime.CellJournal) ----------------
    def to_journal(self) -> Dict:
        """JSON-safe dict losing nothing: floats survive JSON via
        shortest-round-trip repr, so ``from_journal(to_journal(r))`` is
        field-for-field equal to ``r`` — the bit-identical-resume
        contract of the campaign journal rests on this."""
        # flat field walk instead of dataclasses.asdict: every field is a
        # scalar or a shallow list, and asdict's recursive deep-copy is the
        # dominant cost of a journal append (~3x the json.dumps itself)
        d = {name: getattr(self, name)
             for name in self.__dataclass_fields__}
        d["jcts"] = list(self.jcts)
        d["jwts"] = list(self.jwts)
        d["slowdowns"] = list(self.slowdowns)
        d["frag_series"] = [list(p) for p in self.frag_series]
        d["event_log"] = [list(e) for e in self.event_log]
        return d

    @classmethod
    def from_journal(cls, d: Dict) -> "MetricsReport":
        """Inverse of :meth:`to_journal` (restores ``event_log`` tuples,
        which JSON flattens to lists)."""
        d = dict(d)
        d["event_log"] = [tuple(e) for e in d.get("event_log", [])]
        return cls(**d)

    def row(self) -> Dict[str, float]:
        return {
            "avg_jrt": self.avg_jrt, "avg_jwt": self.avg_jwt,
            "avg_jct": self.avg_jct, "stability": self.stability,
            "p99_jwt": self.p99_jwt, "n": self.n_finished,
            "frag_gpu": self.frag_gpu, "frag_network": self.frag_network,
            "preemptions": self.preemptions, "failures": self.failures,
            "resizes": self.resizes, "migrations": self.migrations,
            "migration_bytes": self.migration_bytes,
            "goodput": self.goodput,
        }


def job_metrics(jobs: Sequence[Job]) -> MetricsReport:
    done = [j for j in jobs if j.finish_time is not None]
    if not done:
        return MetricsReport(0, 0, 0, 0, 0, 0)
    jrt = np.array([j.finish_time - j.start_time for j in done])
    jwt = np.array([j.start_time - j.arrival for j in done])
    jct = jrt + jwt
    groups: Dict[tuple, List[float]] = defaultdict(list)
    for j, c in zip(done, jct):
        groups[(j.model, j.num_gpus, j.batch_size)].append(float(c))
    stds = [float(np.std(v)) for v in groups.values() if len(v) >= 2]
    makespan = float(max(j.finish_time for j in done)
                     - min(j.arrival for j in done))
    # useful GPU-seconds per wall second: each finished job contributes its
    # contention-free runtime (num_iters × ideal iteration) once — work
    # redone after preemptions/failures inflates JCT but never goodput
    useful = sum(j.ideal_runtime() * j.num_gpus for j in done)
    return MetricsReport(
        avg_jrt=float(jrt.mean()), avg_jwt=float(jwt.mean()),
        avg_jct=float(jct.mean()),
        stability=float(np.mean(stds)) if stds else 0.0,
        p99_jwt=float(np.percentile(jwt, 99)), n_finished=len(done),
        p99_jct=float(np.percentile(jct, 99)),
        makespan=makespan,
        goodput=float(useful / makespan) if makespan > 0 else 0.0,
        jcts=[float(c) for c in jct], jwts=[float(w) for w in jwt])


def cdf_table(samples_by_series: Dict[str, Sequence[float]],
              num_points: int = 50) -> List[tuple]:
    """Long-form CDF table: ``(series, value, cum_frac)`` rows, series in
    insertion order — the layout figure renderers and CSV exports consume
    (:mod:`repro_torch.core.figures`).  Each series is down-sampled by
    :func:`cdf` to at most ``num_points`` retained order statistics."""
    rows: List[tuple] = []
    for name, samples in samples_by_series.items():
        for value, frac in cdf(samples, num_points):
            rows.append((name, value, frac))
    return rows


def cdf(samples: Sequence[float], num_points: int = 50) -> List[List[float]]:
    """Empirical CDF of ``samples`` down-sampled to ``num_points`` rows of
    ``[value, cumulative_fraction]`` — compact enough to embed in JSON."""
    if not len(samples):
        return []
    xs = np.sort(np.asarray(samples, dtype=float))
    n = len(xs)
    if n <= num_points:
        idx = np.arange(n)
    else:
        idx = np.unique(np.linspace(0, n - 1, num_points).astype(int))
    return [[float(xs[i]), float((i + 1) / n)] for i in idx]
