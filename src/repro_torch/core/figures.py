"""Paper-figure experiment specs: headline results as plain tables.

The port's copy of the reference's ``core/figures.py``.  The paper's claims
are curves and tables — JCT vs. offered load across strategies (§9.4,
Fig. 12 / Table 5), per-job contention CDFs (§3, §9.3), fragmentation under
churn (§9, Table 2), and the OCS-vClos vs. vClos fragmentation rescue (§7,
Table 5).  This module pins each of those as a deterministic
:class:`FigureSpec`: a builder that runs the simulator / campaign engine
and returns a :class:`FigureTable` of plain scalars (strings, ints, rounded
floats) with a stable column order.

Two scales share every spec:

* ``smoke`` — seconds-fast slices whose tables equal the reference's; their
  CSVs are byte-identical to the committed ``docs/assets/*.smoke.csv``
  (``tests/test_torch_figures.py``).
* ``paper`` — the full experiment suite (v2 engine, streaming
  aggregation, the 2048-GPU cluster for the CDF sweep) reproducing the
  paper's qualitative orderings; minutes, not hours.

Every builder takes ``device``: where each campaign cell and each direct
:func:`simulate` call resolves its rates, ``"cuda"`` (the default: the
segment-max kernel; raises where there is no card) or ``"cpu"``.  It is not
a meta key: a table is the same on either device.

Rendering lives in :mod:`repro_torch.launch.report` — this module never
imports matplotlib, so the data path runs on hosts without it.

    from repro_torch.core import build_figure
    fig = build_figure("jct-vs-load", scale="smoke", device="cpu")
    print(fig.columns); print(fig.rows[0])

CLI: ``python -m repro_torch.launch.report --scale {smoke,paper}``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import dataclasses

from .campaign import (CampaignGrid, CampaignResult, run_campaign,
                       run_windowed_campaign)
from .config import SimConfig
from .jobs import Job
from .metrics import cdf_table
from .simulator import simulate
from .strategies import get_strategy
from .topology import (CLUSTER512, CLUSTER512_OCS, CLUSTER2048, TESTBED32,
                       apply_gpu_mix)
from .traces import TraceSource
from .workloads import (WorkloadSpec, generate_events, generate_trace,
                        save_trace_csv)

#: the checked-in Alibaba PAI task-taxonomy sample (~50 task rows) that
#: backs the smoke-scale `real-trace` figure — byte-stable by construction
ALIBABA_SAMPLE = os.path.join(os.path.dirname(__file__), os.pardir,
                              "data", "alibaba_sample.csv")

SCALES = ("smoke", "paper")

#: progress callback type: one human-readable line per completed step
Progress = Optional[Callable[[str], None]]


@dataclass(frozen=True)
class FigureTable:
    """One built figure: plain tabular data plus rendering hints.

    ``rows`` hold only strings / ints / floats already rounded to their
    publication precision, so serialising a table (CSV, markdown) is a
    pure formatting step and byte-stable across runs."""

    name: str
    title: str
    caption: str
    kind: str                      # "line" | "cdf" | "timeline" | "bar"
    columns: Tuple[str, ...]
    rows: Tuple[Tuple, ...]
    xcol: str = ""                 # renderer hints (empty: first columns)
    ycol: str = ""
    series: str = ""               # column that splits rows into curves
    meta: Tuple[Tuple[str, object], ...] = ()   # sorted (key, value) pairs

    def meta_dict(self) -> Dict[str, object]:
        return dict(self.meta)

    def series_values(self) -> List[str]:
        """Distinct series labels in first-appearance order."""
        if not self.series:
            return []
        i = self.columns.index(self.series)
        seen: Dict[str, None] = {}
        for r in self.rows:
            seen.setdefault(r[i])
        return list(seen)


@dataclass(frozen=True)
class FigureSpec:
    """A registered experiment: name, one-liner, and the scale-aware
    builder.  Title/caption/kind live on the built :class:`FigureTable`
    (single source of truth — the registry never duplicates them)."""

    name: str
    description: str
    builder: Callable[..., FigureTable] = field(repr=False, default=None)


def _r(x: float, nd: int) -> float:
    return round(float(x), nd)


def _meta(**kv) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted(kv.items()))


def _campaign_config(workers: Optional[int], store: str,
                     engine: Optional[str] = None,
                     fault: Optional[Dict] = None) -> SimConfig:
    # engine v2 by default: the default engine is the contract the paper
    # -scale streaming path is benchmarked on; v1 (parity debugging)
    # and batched (lockstep lane runs, docs/batched.md) are reachable via
    # --engine on the sweep/report CLIs — all bit-identical schedules
    return SimConfig(engine=engine or "v2", workers=workers, store=store,
                     **(fault or {}))


def _journal_kwargs(resume_dir: Optional[str], name: str) -> Dict[str, str]:
    """Per-figure journal under ``resume_dir``: continue it when present,
    start it otherwise — re-running a crashed ``--resume DIR`` report
    picks up every figure where it left off (docs/robustness.md)."""
    if resume_dir is None:
        return {}
    path = os.path.join(resume_dir, f"{name}.journal.jsonl")
    return {"resume": path} if os.path.exists(path) else {"journal": path}


def _partial_meta(res: CampaignResult) -> Dict[str, object]:
    """Gap accounting for incomplete campaigns.  Empty for complete ones,
    so the committed (byte-gated) gallery's meta lines never change on
    the clean path; renderers annotate gaps when the keys appear."""
    missing = res.missing_cells()
    if not missing and not res.failed_cells:
        return {}
    return {"missing_cells": len(missing),
            "failed_cells": len(res.failed_cells),
            "grid_cells": res.grid.size}


# ---------------------------------------------------------------------------
# Figure builders
# ---------------------------------------------------------------------------

def _build_jct_vs_load(scale: str, workers: Optional[int] = None,
                       progress: Progress = None,
                       engine: Optional[str] = None,
                       fault: Optional[Dict] = None,
                       resume_dir: Optional[str] = None,
                       device: str = "cuda") -> FigureTable:
    """Strategy × load mean-JCT sweep (Fig. 12 / Table 5)."""
    p = {
        "smoke": dict(spec=CLUSTER512, ocs=None, jobs=60, loads=(200.0, 120.0),
                      strategies=("best", "vclos", "sr", "ecmp"),
                      store="full"),
        "paper": dict(spec=CLUSTER512, ocs=CLUSTER512_OCS, jobs=400,
                      loads=(200.0, 120.0, 80.0),
                      strategies=("best", "ocs-vclos", "vclos", "sr", "ecmp"),
                      store="stream"),
    }[scale]
    grid = CampaignGrid(strategies=p["strategies"], loads=p["loads"])
    res = run_campaign(
        p["spec"], grid,
        workload=WorkloadSpec(num_jobs=p["jobs"], max_gpus=256, seed=0),
        ocs_spec=p["ocs"], progress=progress,
        config=_campaign_config(workers, p["store"], engine, fault),
        device=device, **_journal_kwargs(resume_dir, "jct-vs-load"))
    cols = ("strategy", "load", "jct_mean", "jct_p99", "queue_delay_mean",
            "contention_ratio_mean", "n_finished")
    rows = tuple(
        (r["strategy"], _r(r["load"], 1), _r(r["jct_mean"], 1),
         _r(r["jct_p99"], 1), _r(r["queue_delay_mean"], 1),
         _r(r["contention_ratio_mean"], 3), int(r["n_finished"]))
        for r in res.aggregate())
    return FigureTable(
        name="jct-vs-load", kind="line", columns=cols, rows=rows,
        xcol="load", ycol="jct_mean", series="strategy",
        title="Mean JCT vs. offered load",
        caption=("Strategy × load sweep on the shared per-(load, seed) "
                 "trace (paper §9.4, Fig. 12 / Table 5): isolated "
                 "strategies (best, vClos, OCS-vClos) dodge the ECMP "
                 "hash-collision slowdown that tips the queue over as the "
                 "inter-arrival gap λ shrinks.  Smaller load value = "
                 "heavier offered load."),
        meta=_meta(scale=scale, gpus=p["spec"].num_gpus, jobs=p["jobs"],
                   loads=p["loads"], engine=engine or "v2", store=p["store"],
                   **_partial_meta(res)))


def _build_contention_cdf(scale: str, workers: Optional[int] = None,
                          progress: Progress = None,
                          engine: Optional[str] = None,
                          fault: Optional[Dict] = None,
                          resume_dir: Optional[str] = None,
                          device: str = "cuda") -> FigureTable:
    """Per-job contention-ratio CDFs (§3 / §9.3, Fig. 13-style)."""
    p = {
        "smoke": dict(spec=CLUSTER512, jobs=60, load=120.0, max_gpus=256,
                      strategies=("ecmp", "sr", "vclos"), points=25,
                      store="full"),
        # the 2048-GPU streaming path: ~1500 jobs condensed to
        # ≤512 order statistics per cell
        "paper": dict(spec=CLUSTER2048, jobs=1500, load=40.0, max_gpus=1024,
                      strategies=("ecmp", "sr", "vclos"), points=50,
                      store="stream"),
    }[scale]
    grid = CampaignGrid(strategies=p["strategies"], loads=(p["load"],))
    res = run_campaign(
        p["spec"], grid,
        workload=WorkloadSpec(num_jobs=p["jobs"], max_gpus=p["max_gpus"],
                              seed=0),
        progress=progress,
        config=_campaign_config(workers, p["store"], engine, fault),
        device=device, **_journal_kwargs(resume_dir, "contention-cdf"))
    samples = {s: [v for c in res.cells if c.strategy == s
                   for v in c.report.slowdowns]
               for s in p["strategies"]}
    rows = tuple((s, _r(v, 4), _r(f, 4))
                 for s, v, f in cdf_table(samples, p["points"]))
    return FigureTable(
        name="contention-cdf", kind="cdf",
        columns=("strategy", "slowdown", "cum_frac"), rows=rows,
        xcol="slowdown", ycol="cum_frac", series="strategy",
        title="Contention-ratio CDF per strategy",
        caption=("Per-job contention ratio (actual JRT / contention-free "
                 "JRT; 1.0 = perfectly isolated) pooled over finished "
                 "jobs.  vClos sits at exactly 1.0 by construction; ECMP's "
                 "tail is the §3.1 hash-collision slowdown."),
        meta=_meta(scale=scale, gpus=p["spec"].num_gpus, jobs=p["jobs"],
                   load=p["load"], engine=engine or "v2", store=p["store"],
                   **_partial_meta(res)))


def _build_frag_timeline(scale: str, workers: Optional[int] = None,
                         progress: Progress = None,
                         engine: Optional[str] = None,
                         fault: Optional[Dict] = None,
                         resume_dir: Optional[str] = None,
                         device: str = "cuda") -> FigureTable:
    """Fragmentation index over time under churn: packed vs. scattered
    placement, with and without the migration-defragmentation pass.

    Every variant replays the identical trace + event sequence and samples
    on the identical defrag-tick grid (the no-migration variant is the
    `best` strategy with ``supports_migration`` stripped, so its ticks
    sample without moving jobs) — the curves are paired, never a sampling
    artifact.

    ``fault``/``resume_dir`` are accepted for builder-signature parity but
    inert: this figure is three direct :func:`simulate` calls (seconds at
    either scale), not a campaign — there are no cells to journal."""
    p = {
        "smoke": dict(jobs=120, mtbf=8000.0, preempt=0.15, defrag=2000.0),
        "paper": dict(jobs=400, mtbf=8000.0, preempt=0.15, defrag=2000.0),
    }[scale]
    wl = WorkloadSpec(num_jobs=p["jobs"], max_gpus=256, seed=0,
                      mean_interarrival=60.0,
                      preempt_fraction=p["preempt"],
                      server_mtbf=p["mtbf"], fail_duration=1800.0)
    trace = generate_trace(wl)
    events = tuple(generate_events(wl, trace, CLUSTER512))
    packed_no_mig = type(get_strategy("best"))()
    packed_no_mig.supports_migration = False
    variants = (("best (defrag)", "best"),
                ("best (no defrag)", packed_no_mig),
                ("ocs-relax (scattered)", "ocs-relax"))
    rows: List[Tuple] = []
    extra: Dict[str, object] = {}
    for variant, strat in variants:
        rep = simulate(CLUSTER512, trace, config=SimConfig(
            strategy=strat, events=events, engine=engine or "v2",
            defrag_interval=p["defrag"]), device=device)
        if progress is not None:
            progress(f"[frag-timeline] {variant}: migrations="
                     f"{rep.migrations} samples={len(rep.frag_series)}")
        rows.extend((variant, _r(t, 1), _r(f, 4))
                    for t, f in rep.frag_series)
        extra[f"migrations[{variant}]"] = rep.migrations
        extra[f"mean_frag[{variant}]"] = (
            _r(sum(f for _, f in rep.frag_series)
               / max(1, len(rep.frag_series)), 4))
    return FigureTable(
        name="frag-timeline", kind="timeline",
        columns=("variant", "t", "frag_index"), rows=tuple(rows),
        xcol="t", ycol="frag_index", series="variant",
        title="Fragmentation under churn: packed vs. scattered placement",
        caption=("frag_index = share of idle GPUs stranded outside whole "
                 "idle servers, sampled on one shared defrag-tick grid "
                 "while preemptions and server failures churn the cluster "
                 "(paper §9, Table 2).  Locality-packed placement (`best`) "
                 "keeps stranded capacity low; dropping the locality "
                 "constraint (`ocs-relax`) strands most idle GPUs.  On an "
                 "already-packed cluster the migration pass adds only "
                 "marginal repair (see the migrations count) — locality at "
                 "placement time, not repair, carries the effect."),
        meta=_meta(scale=scale, gpus=CLUSTER512.num_gpus, jobs=p["jobs"],
                   server_mtbf=p["mtbf"], preempt_fraction=p["preempt"],
                   defrag_interval=p["defrag"], engine=engine or "v2",
                   **extra))


def _build_ocs_comparison(scale: str, workers: Optional[int] = None,
                          progress: Progress = None,
                          engine: Optional[str] = None,
                          fault: Optional[Dict] = None,
                          resume_dir: Optional[str] = None,
                          device: str = "cuda") -> FigureTable:
    """OCS-vClos vs. vClos vs. SR/ECMP under fragmentation pressure."""
    # smoke reuses the golden-trace workload (200 jobs, λ=120, seed 0 —
    # the ecmp=13417.8 / sr=3731.4 snapshot of tests/test_campaign.py), so
    # this figure and the pinned goldens can never silently diverge
    p = {
        "smoke": dict(jobs=200, load=120.0, store="full"),
        "paper": dict(jobs=400, load=100.0, store="stream"),
    }[scale]
    grid = CampaignGrid(
        strategies=("ocs-vclos", "vclos", "sr", "ecmp"), loads=(p["load"],))
    res = run_campaign(
        CLUSTER512, grid,
        workload=WorkloadSpec(num_jobs=p["jobs"], max_gpus=256, seed=0),
        ocs_spec=CLUSTER512_OCS, progress=progress,
        config=_campaign_config(workers, p["store"], engine, fault),
        device=device, **_journal_kwargs(resume_dir, "ocs-comparison"))
    cols = ("strategy", "jct_mean", "queue_delay_mean", "frag_gpu",
            "frag_network", "n_finished")
    rows = tuple(
        (r["strategy"], _r(r["jct_mean"], 1), _r(r["queue_delay_mean"], 1),
         int(r["frag_gpu"]), int(r["frag_network"]), int(r["n_finished"]))
        for r in res.aggregate())
    return FigureTable(
        name="ocs-comparison", kind="bar", columns=cols, rows=rows,
        xcol="strategy", ycol="jct_mean", series="",
        title="OCS-vClos vs. vClos vs. baselines under heavy load",
        caption=("λ=%g s arrivals on CLUSTER512 (OCS-vClos on the OCS-"
                 "equipped preset): `frag_network` counts placement "
                 "attempts blocked by network fragmentation — the blocking "
                 "the OCS layer's rewiring of idle circuits exists to "
                 "relieve (paper §7, Table 5)." % p["load"]),
        meta=_meta(scale=scale, gpus=CLUSTER512.num_gpus, jobs=p["jobs"],
                   load=p["load"], engine=engine or "v2", store=p["store"],
                   **_partial_meta(res)))


def _build_real_trace(scale: str, workers: Optional[int] = None,
                      progress: Progress = None,
                      engine: Optional[str] = None,
                      fault: Optional[Dict] = None,
                      resume_dir: Optional[str] = None,
                      device: str = "cuda") -> FigureTable:
    """Measured-trace replay through the streaming windowed campaign.

    ``smoke`` replays the committed Alibaba PAI task-taxonomy sample
    (:data:`ALIBABA_SAMPLE`) on the 32-GPU testbed — real (fixture) data,
    byte-stable gallery output.  ``paper`` generates a long native-schema
    trace to a temp file and streams it back through
    :class:`repro_torch.core.traces.TraceSource` windows, exercising the same
    ingestion path at campaign scale.

    ``resume_dir`` is accepted for builder-signature parity but inert:
    windowed replay does not journal (each window is seconds of work).

    The paper-scale trace lives in a temporary directory that is removed
    when the builder returns."""
    with contextlib.ExitStack() as stack:
        if scale == "smoke":
            source = TraceSource(os.path.normpath(ALIBABA_SAMPLE),
                                 format="alibaba")
            p = dict(spec=TESTBED32, strategies=("vclos", "sr", "ecmp"),
                     window=10, stride=10, store="full",
                     trace="alibaba_sample.csv")
        else:
            tmp = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="real-trace-"))
            path = os.path.join(tmp, "trace.csv")
            save_trace_csv(generate_trace(WorkloadSpec(
                num_jobs=5000, max_gpus=256, seed=0,
                mean_interarrival=100.0)), path)
            source = TraceSource(path, format="csv")
            p = dict(spec=CLUSTER512,
                     strategies=("best", "vclos", "sr", "ecmp"),
                     window=1000, stride=1000, store="stream",
                     trace="generated-5000.csv")
        grid = CampaignGrid(strategies=p["strategies"], loads=(120.0,))
        res = run_windowed_campaign(
            p["spec"], grid, source, p["window"], p["stride"],
            progress=progress,
            config=_campaign_config(workers, p["store"], engine, fault),
            device=device)
        fmt = source.resolve_format()
    adapter = source.last_adapter
    cols = ("strategy", "jct_mean", "jct_p99", "queue_delay_mean",
            "contention_ratio_mean", "n_finished")
    rows = tuple(
        (r["strategy"], _r(r["jct_mean"], 1), _r(r["jct_p99"], 1),
         _r(r["queue_delay_mean"], 1), _r(r["contention_ratio_mean"], 3),
         int(r["n_finished"]))
        for r in res.aggregate())
    return FigureTable(
        name="real-trace", kind="bar", columns=cols, rows=rows,
        xcol="strategy", ycol="jct_mean", series="",
        title="Measured-trace replay (windowed streaming ingestion)",
        caption=("External trace streamed through the TraceSource adapter "
                 "layer and replayed as %d-job windows, one seeds-axis "
                 "slice per window (paper §9: results on measured, not "
                 "synthetic, arrivals).  Every strategy column pools the "
                 "same windows of the same normalized trace "
                 "(docs/traces.md)." % p["window"]),
        meta=_meta(scale=scale, gpus=p["spec"].num_gpus,
                   trace=p["trace"], format=fmt,
                   windows=len(res.grid.seeds), window_jobs=p["window"],
                   skipped=(adapter.skipped if adapter is not None else 0),
                   engine=engine or "v2", store=p["store"],
                   **_partial_meta(res)))


def phase_complementary_trace(waves: int, gap: float, dlrm_iters: int,
                              res_iters: int) -> List[Job]:
    """The deterministic phase-complementary workload behind the
    ``hetero-interleave`` figure (and the strictly-beats assertion in
    ``tests/test_figures.py``).

    Eight 40-GPU residents pin the 16 leafs of CLUSTER512 in pairs (five
    servers each: even leafs full, odd leafs keep three idle servers) —
    comm-bound ``vgg16@16`` on leafs 0-7, compute-bound ``resnet50@64``
    (allreduce fully hidden by the β-overlap) on leafs 8-15.  Both
    resident kinds run the same 40-GPU ring allreduce, so their per-leaf
    *flow counts* are identical and offset-blind placement cannot tell
    them apart; only the duty-cycle view can.  Waves of 64-GPU ``dlrm``
    jobs (duty ≈ 0.8) then arrive one at a time and must choose three
    partially-idle leafs: offset-aware placement steers them onto the
    overlap-immune resnet leafs, offset-blind onto whichever tie-break
    comes first — the comm-bound residents."""
    jobs: List[Job] = []
    jid = 0
    for i in range(4):
        jobs.append(Job(jid, "vgg16", 40, 16, float(i), res_iters,
                        allreduce_algo="ring"))
        jid += 1
    for i in range(4):
        jobs.append(Job(jid, "resnet50", 40, 64, 4.0 + i, res_iters,
                        allreduce_algo="ring"))
        jid += 1
    for i in range(waves):
        jobs.append(Job(jid, "dlrm", 64, 256, 100.0 + gap * i, dlrm_iters))
        jid += 1
    return jobs


#: the hetero-interleave figure's mixed-generation fleet: per-tier link
#: speeds (2× leaf uplinks, 0.8× NICs) + a half-and-half GPU mix
HETERO_FLEET = apply_gpu_mix(
    dataclasses.replace(CLUSTER512, leaf_uplink_gbps=200.0,
                        server_nic_gbps=80.0),
    [("h100", 1.0, 0.5), ("a100", 0.62, 0.5)])


def _build_hetero_interleave(scale: str, workers: Optional[int] = None,
                             progress: Progress = None,
                             engine: Optional[str] = None,
                             fault: Optional[Dict] = None,
                             resume_dir: Optional[str] = None,
                             device: str = "cuda") -> FigureTable:
    """Contention CDFs: homogeneous vs mixed-generation fleets × offset
    -aware vs offset-blind placement (docs/heterogeneous.md).

    Four paired variants replay the identical phase-complementary trace:
    {homogeneous CLUSTER512, :data:`HETERO_FLEET`} × {``contention-
    affinity``, ``contention-affinity-time``}.  The meta carries each
    variant's mean JCT — the offset-aware plugin must strictly beat the
    offset-blind one on both fleets (pinned by ``tests/test_figures.py``).

    ``fault``/``resume_dir`` are accepted for builder-signature parity but
    inert: this figure is four direct :func:`simulate` calls (instant at
    either scale), not a campaign — there are no cells to journal."""
    p = {
        "smoke": dict(waves=4, gap=500.0, dlrm_iters=600, res_iters=15000,
                      points=25),
        "paper": dict(waves=8, gap=500.0, dlrm_iters=600, res_iters=25000,
                      points=50),
    }[scale]
    trace = phase_complementary_trace(p["waves"], p["gap"], p["dlrm_iters"],
                                      p["res_iters"])
    variants = (("affinity / homog", CLUSTER512, "contention-affinity"),
                ("affinity-time / homog", CLUSTER512,
                 "contention-affinity-time"),
                ("affinity / hetero", HETERO_FLEET, "contention-affinity"),
                ("affinity-time / hetero", HETERO_FLEET,
                 "contention-affinity-time"))
    samples: Dict[str, List[float]] = {}
    extra: Dict[str, object] = {}
    for variant, spec, strat in variants:
        rep = simulate(spec, trace, config=SimConfig(
            strategy=strat, engine=engine or "v2"), device=device)
        samples[variant] = list(rep.slowdowns)
        extra[f"mean_jct[{variant}]"] = _r(rep.avg_jct, 1)
        if progress is not None:
            progress(f"[hetero-interleave] {variant}: "
                     f"mean JCT {rep.avg_jct:.1f}s")
    rows = tuple((s, _r(v, 4), _r(f, 4))
                 for s, v, f in cdf_table(samples, p["points"]))
    return FigureTable(
        name="hetero-interleave", kind="cdf",
        columns=("variant", "slowdown", "cum_frac"), rows=rows,
        xcol="slowdown", ycol="cum_frac", series="variant",
        title="Heterogeneous fleets + time-domain interleaving",
        caption=("Per-job contention-ratio CDFs on one phase-complementary "
                 "trace: comm-bound and compute-bound 40-GPU residents pin "
                 "the fabric with identical flow counts while waves of "
                 "alltoall-heavy dlrm jobs choose leafs.  Offset-aware "
                 "placement (`contention-affinity-time`) reads the "
                 "duty-cycle view and steers communicators onto "
                 "overlap-immune leafs that flow-count load cannot "
                 "distinguish; the mixed-generation fleet (2x leaf "
                 "uplinks, 0.8x NICs, straggler-scaled h100/a100 halves) "
                 "shifts both CDFs right without erasing the ordering "
                 "(docs/heterogeneous.md)."),
        meta=_meta(scale=scale, gpus=CLUSTER512.num_gpus,
                   jobs=len(trace), waves=p["waves"],
                   engine=engine or "v2", **extra))


#: the registry, in gallery order
FIGURES: Dict[str, FigureSpec] = {
    spec.name: spec for spec in (
        FigureSpec("jct-vs-load", "strategy × load mean-JCT sweep "
                   "(Fig. 12 / Table 5)", _build_jct_vs_load),
        FigureSpec("contention-cdf", "per-job contention-ratio CDFs "
                   "(§3.1, §9.3)", _build_contention_cdf),
        FigureSpec("frag-timeline", "fragmentation under churn: packed "
                   "vs. scattered placement (Table 2)",
                   _build_frag_timeline),
        FigureSpec("ocs-comparison", "OCS-vClos vs. vClos fragmentation "
                   "rescue (§7, Table 5)", _build_ocs_comparison),
        FigureSpec("real-trace", "measured-trace replay via streaming "
                   "windowed ingestion (§9)", _build_real_trace),
        FigureSpec("hetero-interleave", "hetero fleets × offset-aware vs "
                   "offset-blind placement (docs/heterogeneous.md)",
                   _build_hetero_interleave),
    )
}


def figure_names() -> Tuple[str, ...]:
    return tuple(FIGURES)


def build_figure(name: str, scale: str = "smoke",
                 workers: Optional[int] = None,
                 progress: Progress = None,
                 engine: Optional[str] = None,
                 fault: Optional[Dict] = None,
                 resume_dir: Optional[str] = None,
                 device: str = "cuda") -> FigureTable:
    """Build one registered figure at the given scale.

    ``fault`` — optional dict of :class:`SimConfig` fault-policy overrides
    (``cell_timeout`` / ``max_retries`` / ``retry_backoff`` /
    ``quarantine``) applied to campaign-backed figures.  ``resume_dir`` —
    directory of per-figure cell journals: each campaign journals to
    ``<resume_dir>/<name>.journal.jsonl`` and resumes from it when it
    already exists (see docs/robustness.md).  ``device`` — where every
    campaign cell and direct :func:`simulate` call resolves its rates:
    ``"cuda"`` (the default: the segment-max kernel) or ``"cpu"``; a table
    is the same on either."""
    if scale not in SCALES:
        raise ValueError(f"unknown scale {scale!r}; choose from {SCALES}")
    if name not in FIGURES:
        raise ValueError(f"unknown figure {name!r}; "
                         f"choose from {figure_names()}")
    return FIGURES[name].builder(scale, workers=workers, progress=progress,
                                 engine=engine, fault=fault,
                                 resume_dir=resume_dir, device=device)


def build_all(scale: str = "smoke", names: Optional[Tuple[str, ...]] = None,
              workers: Optional[int] = None,
              progress: Progress = None,
              engine: Optional[str] = None,
              fault: Optional[Dict] = None,
              resume_dir: Optional[str] = None,
              device: str = "cuda") -> List[FigureTable]:
    """Build the figure suite in registry (gallery) order."""
    return [build_figure(n, scale, workers=workers, progress=progress,
                         engine=engine, fault=fault, resume_dir=resume_dir,
                         device=device)
            for n in (names if names is not None else figure_names())]


def qualitative_checks(tables: List[FigureTable],
                       allow_partial: bool = False) -> List[str]:
    """The paper's headline orderings, as checkable facts.  Returns a list
    of violations (empty = the reproduced data tells the paper's story):
    on every JCT table, each isolated strategy strictly beats ECMP's mean
    JCT at every load.

    Incomplete tables (built from campaigns with quarantined or missing
    cells — their meta carries ``missing_cells``) are a violation in
    their own right: orderings over partial data could silently pass on
    exactly the cells that happened to survive.  ``allow_partial=True``
    downgrades that to skipping the ordering checks for those tables
    (the gap stays visible in the rendered gallery)."""
    problems: List[str] = []
    for tab in tables:
        missing = tab.meta_dict().get("missing_cells", 0)
        if missing:
            if not allow_partial:
                problems.append(
                    f"{tab.name}: incomplete campaign data ({missing} of "
                    f"{tab.meta_dict().get('grid_cells', '?')} cells "
                    f"missing); refusing qualitative gates on partial "
                    f"data (pass allow_partial=True / --allow-partial to "
                    f"render with visible gaps)")
            continue
        if tab.name not in ("jct-vs-load", "ocs-comparison"):
            continue
        cols = tab.columns
        i_strat, i_jct = cols.index("strategy"), cols.index("jct_mean")
        i_load = cols.index("load") if "load" in cols else None
        by_load: Dict[object, Dict[str, float]] = {}
        for r in tab.rows:
            load = r[i_load] if i_load is not None else ""
            by_load.setdefault(load, {})[r[i_strat]] = r[i_jct]
        for load, jcts in sorted(by_load.items(), key=lambda kv: str(kv[0])):
            if "ecmp" not in jcts:
                continue
            for s, v in sorted(jcts.items()):
                if s != "ecmp" and get_strategy(s).isolated \
                        and not v < jcts["ecmp"]:
                    problems.append(
                        f"{tab.name}: {s} jct_mean {v} !< ecmp "
                        f"{jcts['ecmp']} at load {load}")
    return problems
