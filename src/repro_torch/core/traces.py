"""Real-trace ingestion: normalizing adapters + bounded-memory streaming.

The paper's credibility jump (§9) comes from replaying *measured*
production traces, not synthetic Poisson mixes.  This module is the
``TraceSource`` layer that makes external cluster traces first-class
campaign inputs:

  * :class:`TraceAdapter` — the normalizing protocol: schema inference
    (``sniff`` over the CSV header), column mapping, string-job-id
    interning, and per-row validation, producing a stream of
    :class:`repro_torch.core.jobs.Job`.
  * Concrete adapters: ``csv`` (our native ``TRACE_FIELDS`` schema —
    bit-identical to :func:`repro_torch.core.workloads.load_trace_csv`),
    ``alibaba`` (the PAI/GPU *task* taxonomy: worker / parameter-server /
    evaluator rows aggregated into per-job GPU sizes), and ``generic``
    (Philly/Helios-style job-level CSVs via column aliases).
  * :class:`TraceSource` — one handle over a trace file: format
    auto-detection, a **bounded-memory streaming reader** (chunked
    iteration through a fixed-size reorder buffer — million-job traces
    replay without materialising the whole trace), an eager loader
    (the streaming reader's differential oracle), GPU-size clamping and
    arrival rebasing.
  * :func:`iter_windows` — overlapping job-count windows over a (possibly
    endless) job stream, the unit :func:`repro_torch.core.campaign.
    run_windowed_campaign` shards a long trace into.
  * :func:`summarize_jobs` / :func:`fit_workload` — single-pass
    GPU-size-mix extraction and arrival-process / duration fitting, so a
    measured trace yields a matching synthetic
    :class:`~repro_torch.core.workloads.WorkloadSpec` for paired
    synthetic-vs-measured ablations.

Contracts (enforced by ``tests/test_traces.py``):

  * ``csv`` adapter round-trip — ``generate_trace`` → ``save_trace_csv``
    → ``TraceSource`` reproduces the synthetic jobs **bit-identically**
    (same validation code as ``load_trace_csv``, by construction).
  * streaming ≡ eager — on any file sorted to within
    ``reorder_window`` jobs, ``iter_jobs()`` yields exactly
    ``load()``'s jobs, job for job.
  * deterministic normalization — interned ids follow first-appearance
    order; model assignment hashes the raw job id (crc32, stable across
    runs and hosts); re-reading a file reproduces the identical jobs.

How to add an adapter: ``docs/traces.md``.
"""

from __future__ import annotations

import csv
import dataclasses
import heapq
import math
import zlib
from dataclasses import dataclass, field
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

from .jobs import BATCHES, PROFILES, Job
from .workloads import (ALLREDUCE_ALGOS, TRACE_FIELDS, WorkloadSpec,
                        is_float_literal, job_from_trace_row,
                        parse_trace_time)


class TraceFormatError(ValueError):
    """A trace file's schema or row stream violates an adapter contract."""


# ---------------------------------------------------------------------------
# Normalization building blocks
# ---------------------------------------------------------------------------

class JobIdInterner:
    """Deterministic string-job-id → dense int interning.

    Real traces key jobs by strings (Alibaba ``job_name`` hashes, Philly
    GUIDs); the simulator keys running jobs by ``int``.  Ids are assigned
    in first-appearance order, so re-reading the same file reproduces the
    identical mapping — and two adapters fed the same row stream agree."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, raw: object) -> bool:
        return str(raw) in self._ids

    def intern(self, raw: object) -> int:
        return self._ids.setdefault(str(raw), len(self._ids))

    def mapping(self) -> Dict[str, int]:
        """A copy of the raw-id → interned-id table (for provenance)."""
        return dict(self._ids)


#: model-mix used when a trace carries no model column, in stable name
#: order (dict order would silently re-map every job if PROFILES grew)
_MODEL_POOL: Tuple[str, ...] = tuple(sorted(PROFILES))


def stable_model_for(raw_id: object) -> str:
    """Deterministic model assignment for traces without a model column:
    crc32 of the raw job id over the sorted profile names.  Stable across
    runs, hosts and Python versions (unlike ``hash``), so normalized
    traces — and everything downstream (goldens, figures) — never shift
    under ``PYTHONHASHSEED``."""
    return _MODEL_POOL[zlib.crc32(str(raw_id).encode()) % len(_MODEL_POOL)]


def iters_for_duration(model: str, num_gpus: int, batch_size: int,
                       duration: float) -> int:
    """Iteration count whose contention-free runtime best matches a
    measured wall-clock ``duration`` — how adapters map real durations
    onto the simulator's iteration-based job model (the replayed job then
    *stretches* under contention exactly like a synthetic one)."""
    probe = Job(0, model, num_gpus, batch_size, 0.0, 1)
    return max(1, round(duration / probe.iter_time(1.0)))


# ---------------------------------------------------------------------------
# Adapter protocol + concrete adapters
# ---------------------------------------------------------------------------

#: (line-number, row-dict) pairs as produced by ``csv.DictReader``
Rows = Iterable[Tuple[int, Dict[str, str]]]


class TraceAdapter:
    """Normalizing adapter protocol.

    Subclasses set ``name``/``description``, implement
    :meth:`sniff` (schema inference over the CSV header — used by
    format auto-detection) and :meth:`jobs` (validated, normalized
    ``Job`` stream in file order; **never** materialises the whole
    trace).  Adapters are single-use: one instance per read, so
    interners and skip counters describe exactly one pass."""

    name: str = "?"
    description: str = ""

    def __init__(self) -> None:
        self.interner = JobIdInterner()
        #: rows/jobs dropped by normalization policy (non-GPU jobs,
        #: non-terminated status...) — honest accounting, never silent
        self.skipped: int = 0

    @classmethod
    def sniff(cls, fieldnames: Sequence[str]) -> bool:
        raise NotImplementedError

    def jobs(self, rows: Rows, path: str) -> Iterator[Job]:
        raise NotImplementedError


class NativeCSVAdapter(TraceAdapter):
    """Our own ``TRACE_FIELDS`` schema (``save_trace_csv`` output).

    Reuses :func:`repro_torch.core.workloads.job_from_trace_row` — the exact
    row validator behind ``load_trace_csv`` — so the streamed jobs are
    bit-identical to the eager loader's by construction."""

    name = "csv"
    description = "native TRACE_FIELDS schema (save_trace_csv round-trip)"

    @classmethod
    def sniff(cls, fieldnames: Sequence[str]) -> bool:
        return set(TRACE_FIELDS) <= set(fieldnames or ())

    def jobs(self, rows: Rows, path: str) -> Iterator[Job]:
        seen: set = set()
        for ln, row in rows:
            yield job_from_trace_row(row, path, ln, seen)


class GenericCSVAdapter(TraceAdapter):
    """Philly/Helios-style job-level CSVs via column aliasing.

    One row per job.  Required canonical columns (first present alias
    wins): ``job_id``, ``num_gpus``, ``arrival``, and a duration source —
    ``duration`` | ``end_time`` | ``num_iters``.  Optional columns
    (``model``, ``batch_size``, ``allreduce_algo``, ``deadline``)
    override the deterministic defaults; see ``docs/traces.md`` for the
    full mapping table."""

    name = "generic"
    description = "Philly/Helios-style job-level CSV (column aliases)"

    ALIASES: Dict[str, Tuple[str, ...]] = {
        "job_id": ("job_id", "jobid", "job_name", "jobname", "job"),
        "num_gpus": ("num_gpus", "gpu_num", "gpus", "ngpus", "gpu_count"),
        "arrival": ("arrival", "submit_time", "submitted_time",
                    "submission_time", "start_time"),
        "duration": ("duration", "run_time", "runtime", "exec_time"),
        "end_time": ("end_time", "finish_time"),
        "model": ("model",),
        "batch_size": ("batch_size", "batchsize"),
        "num_iters": ("num_iters", "iterations", "iters"),
        "allreduce_algo": ("allreduce_algo",),
        "deadline": ("deadline",),
    }

    @classmethod
    def _columns(cls, fieldnames: Sequence[str]) -> Dict[str, str]:
        """canonical field → actual column name, for present aliases."""
        have = set(fieldnames or ())
        return {canon: next(a for a in aliases if a in have)
                for canon, aliases in cls.ALIASES.items()
                if any(a in have for a in aliases)}

    @classmethod
    def sniff(cls, fieldnames: Sequence[str]) -> bool:
        cols = cls._columns(fieldnames)
        return ({"job_id", "num_gpus", "arrival"} <= set(cols)
                and bool({"duration", "end_time", "num_iters"} & set(cols)))

    def jobs(self, rows: Rows, path: str) -> Iterator[Job]:
        cols: Optional[Dict[str, str]] = None
        for ln, row in rows:
            if cols is None:
                cols = self._columns(tuple(row))
                missing = {"job_id", "num_gpus", "arrival"} - set(cols)
                if missing or not ({"duration", "end_time", "num_iters"}
                                   & set(cols)):
                    raise TraceFormatError(
                        f"trace {path}: generic adapter cannot map columns "
                        f"{sorted(missing) or ['duration|end_time|num_iters']}"
                        f" onto {sorted(row)}")

            def cell(canon: str) -> str:
                col = cols.get(canon)
                return (row.get(col) or "").strip() if col else ""

            raw_id = cell("job_id")
            if not raw_id:
                raise TraceFormatError(f"trace {path}:{ln}: empty job id")
            if raw_id in self.interner:
                raise TraceFormatError(
                    f"trace {path}:{ln}: duplicate job id {raw_id!r} "
                    f"(generic traces carry one row per job; task-level "
                    f"traces need the alibaba adapter)")
            jid = self.interner.intern(raw_id)
            arrival = parse_trace_time(cell("arrival"), "arrival", path, ln)
            # round(nan) raises ValueError in the reference's parse, so nan
            # is refused with the same message; round(inf) overflows there
            # and here alike
            if not is_float_literal(cell("num_gpus")) \
                    or math.isnan(float(cell("num_gpus"))):
                raise TraceFormatError(
                    f"trace {path}:{ln}: num_gpus "
                    f"{cell('num_gpus')!r} is not a number")
            num_gpus = max(1, round(float(cell("num_gpus"))))
            model = cell("model") or stable_model_for(raw_id)
            if model not in PROFILES:
                raise TraceFormatError(
                    f"trace {path}:{ln}: unknown model {model!r}; "
                    f"choose from {sorted(PROFILES)}")
            batch = int(cell("batch_size") or BATCHES[model][0])
            if batch < 1:
                raise TraceFormatError(
                    f"trace {path}:{ln}: batch_size must be positive "
                    f"(got {batch})")
            algo = cell("allreduce_algo") or "ring"
            if algo not in ALLREDUCE_ALGOS:
                raise TraceFormatError(
                    f"trace {path}:{ln}: unknown allreduce algorithm "
                    f"{algo!r}")
            if cell("num_iters"):
                iters = int(cell("num_iters"))
                if iters < 1:
                    raise TraceFormatError(
                        f"trace {path}:{ln}: num_iters must be positive "
                        f"(got {iters})")
            else:
                if cell("duration"):
                    duration = parse_trace_time(cell("duration"),
                                                "duration", path, ln)
                else:
                    end = parse_trace_time(cell("end_time"), "end_time",
                                           path, ln)
                    duration = end - arrival
                if duration <= 0:
                    self.skipped += 1   # zero-length (failed/killed) job
                    continue
                iters = iters_for_duration(model, num_gpus, batch, duration)
            deadline = parse_trace_time(cell("deadline"), "deadline",
                                        path, ln, allow_none=True)
            yield Job(jid, model, num_gpus, batch, arrival, iters,
                      allreduce_algo=algo, deadline=deadline)


class AlibabaAdapter(TraceAdapter):
    """Alibaba PAI/GPU *task*-level taxonomy → per-job ``Job``s.

    One input row per task (``job_name``, ``task_name``, ``inst_num``,
    ``start_time``, ``end_time``, ``plan_gpu`` [percent of one GPU per
    instance], optional ``status``).  Task roles follow the PAI
    taxonomy: *workers* (``worker``, ``xtensorflow``, ``PyTorchWorker``,
    ``xComputeWorker``, ``chief``) compute gradients on GPUs and define
    the job's GPU size; *parameter servers* (``ps``) store weights on
    CPU and never count toward GPU demand; *evaluators* sometimes hold a
    GPU — they count only when ``plan_gpu > 0``.

    Aggregation is streaming: task rows must be **grouped by job**
    (contiguous ``job_name`` runs — the trace's natural order); a
    job name reappearing after its group closed raises
    :class:`TraceFormatError` instead of silently splitting the job.
    Per job: GPU size = ``round(Σ inst_num × plan_gpu / 100)`` over
    GPU-counting tasks, arrival = earliest task ``start_time``, duration
    = latest ``end_time`` − arrival.  Jobs with no GPU demand, a
    non-``Terminated`` status (when the column exists) or a zero/negative
    duration are skipped (counted in :attr:`skipped`).  Model / batch
    follow the deterministic defaults (:func:`stable_model_for`)."""

    name = "alibaba"
    description = "Alibaba PAI task taxonomy (workers / ps / evaluators)"

    WORKER_TASKS = frozenset({"worker", "xtensorflow", "pytorchworker",
                              "xcomputeworker", "chief"})
    PS_TASKS = frozenset({"ps"})
    EVALUATOR_TASKS = frozenset({"evaluator"})

    @classmethod
    def sniff(cls, fieldnames: Sequence[str]) -> bool:
        have = set(fieldnames or ())
        return ({"job_name", "task_name", "start_time"} <= have
                and bool({"plan_gpu", "inst_num"} & have))

    def jobs(self, rows: Rows, path: str) -> Iterator[Job]:
        cur: Optional[str] = None            # open job group
        gpu_frac = 0.0
        arrival = math.inf
        end = -math.inf
        terminated = True
        first_ln = 0
        closed: set = set()

        def finalize() -> Optional[Job]:
            if cur is None:
                return None
            closed.add(cur)
            if not terminated or gpu_frac <= 0 or not (end > arrival):
                self.skipped += 1
                return None
            jid = self.interner.intern(cur)
            model = stable_model_for(cur)
            batch = int(BATCHES[model][0])
            gpus = max(1, round(gpu_frac))
            iters = iters_for_duration(model, gpus, batch, end - arrival)
            return Job(jid, model, gpus, batch, arrival, iters)

        for ln, row in rows:
            name = (row.get("job_name") or "").strip()
            if not name:
                raise TraceFormatError(f"trace {path}:{ln}: empty job_name")
            if name != cur:
                if name in closed:
                    raise TraceFormatError(
                        f"trace {path}:{ln}: job {name!r} reappears after "
                        f"its task group closed — the streaming alibaba "
                        f"adapter needs task rows grouped by job_name "
                        f"(sort the trace by job_name, start_time first)")
                job = finalize()
                if job is not None:
                    yield job
                cur, gpu_frac, terminated = name, 0.0, True
                arrival, end, first_ln = math.inf, -math.inf, ln
            task = (row.get("task_name") or "").strip().casefold()
            status = (row.get("status") or "").strip()
            if status and status.casefold() != "terminated":
                terminated = False
            # checked in the reference's order: int(float(inst)) first (nan
            # refused there, inf overflows), then the plan
            inst_raw = (row.get("inst_num") or "1").strip()
            plan_raw = (row.get("plan_gpu") or "0").strip()
            inst_ok = not inst_raw or (is_float_literal(inst_raw)
                                       and not math.isnan(float(inst_raw)))
            if inst_ok:
                inst = int(float(inst_raw or 1))
            if not inst_ok or (plan_raw and not is_float_literal(plan_raw)):
                raise TraceFormatError(
                    f"trace {path}:{ln}: bad inst_num/plan_gpu "
                    f"({row.get('inst_num')!r}, {row.get('plan_gpu')!r})")
            plan = float(plan_raw or 0)
            # ps tasks live on CPU and never count toward GPU demand
            counts_gpu = (task in self.WORKER_TASKS
                          or (task in self.EVALUATOR_TASKS and plan > 0))
            if counts_gpu:
                gpu_frac += max(0, inst) * max(0.0, plan) / 100.0
            start = parse_trace_time(row.get("start_time") or "",
                                     "start_time", path, ln,
                                     allow_none=True)
            stop = parse_trace_time(row.get("end_time") or "",
                                    "end_time", path, ln, allow_none=True)
            if start is not None:
                arrival = min(arrival, start)
            if stop is not None:
                end = max(end, stop)
        job = finalize()
        if job is not None:
            yield job


#: registered adapters; detection tries them in this order (most specific
#: schema first — the native schema is a superset no other adapter claims)
ADAPTERS: Dict[str, type] = {
    NativeCSVAdapter.name: NativeCSVAdapter,
    AlibabaAdapter.name: AlibabaAdapter,
    GenericCSVAdapter.name: GenericCSVAdapter,
}

TRACE_FORMATS: Tuple[str, ...] = tuple(ADAPTERS) + ("auto",)


def detect_format(fieldnames: Sequence[str]) -> str:
    """Schema inference: the first registered adapter whose :meth:`sniff`
    accepts the header claims the file."""
    for name, cls in ADAPTERS.items():
        if cls.sniff(fieldnames):
            return name
    raise TraceFormatError(
        f"no trace adapter recognises columns {sorted(fieldnames or ())}; "
        f"registered formats: {sorted(ADAPTERS)} (docs/traces.md)")


# ---------------------------------------------------------------------------
# TraceSource: one handle over a trace file
# ---------------------------------------------------------------------------

@dataclass
class TraceSource:
    """A trace file plus its normalization policy.

    ``format`` — an :data:`ADAPTERS` key or ``"auto"`` (header-sniffed).
    ``max_gpus`` — clamp normalized job sizes (production traces carry
    jobs larger than any simulated cluster; ``run_campaign`` refuses
    unplaceable jobs, so clamp to the cluster size).  ``rebase`` —
    subtract the first emitted arrival so epoch timestamps replay from
    t≈0.  ``reorder_window`` — the streaming reader's bounded reorder
    buffer (jobs): files sorted to within this many jobs stream in exact
    ``(arrival, job_id)`` order; worse disorder raises instead of
    silently emitting an out-of-order trace.

    ``iter_jobs()`` is the bounded-memory path (O(reorder_window) jobs
    resident); ``load()`` is the eager differential oracle (materialise
    + full sort).  On any in-window-sorted file the two are job-for-job
    identical (``tests/test_traces.py``)."""

    path: str
    format: str = "auto"
    max_gpus: Optional[int] = None
    rebase: bool = False
    reorder_window: int = 8192
    #: filled by the most recent read: adapter skip count + id mapping
    last_adapter: Optional[TraceAdapter] = field(default=None, repr=False,
                                                 compare=False)

    def __post_init__(self) -> None:
        if self.format not in TRACE_FORMATS:
            raise ValueError(f"unknown trace format {self.format!r}; "
                             f"choose from {TRACE_FORMATS}")
        if self.reorder_window < 1:
            raise ValueError("reorder_window must be >= 1")

    # -- format resolution --------------------------------------------------
    def resolve_format(self) -> str:
        """The concrete adapter name (sniffs the header for ``auto``)."""
        if self.format != "auto":
            return self.format
        with open(self.path, newline="") as f:
            header = next(csv.reader(f), [])
        if not header:
            raise TraceFormatError(
                f"trace {self.path}: empty file (no header row)")
        return detect_format(header)

    def _open(self):
        adapter = ADAPTERS[self.resolve_format()]()
        self.last_adapter = adapter
        f = open(self.path, newline="")
        reader = csv.DictReader(f)
        if self.format != "auto" and self.format == NativeCSVAdapter.name:
            missing = set(TRACE_FIELDS) - set(reader.fieldnames or ())
            if missing:
                f.close()
                raise ValueError(f"trace {self.path}: missing columns "
                                 f"{sorted(missing)}")
        return f, adapter, enumerate(reader, start=2)

    # -- reading ------------------------------------------------------------
    def iter_jobs(self) -> Iterator[Job]:
        """Stream normalized jobs in ``(arrival, job_id)`` order with
        bounded memory (the reorder buffer plus one CSV row)."""
        f, adapter, rows = self._open()
        heap: List[Tuple[float, int, Job]] = []
        last: Tuple[float, int] = (-math.inf, -1)
        offset: Optional[float] = None

        def emit(job: Job) -> Job:
            nonlocal last, offset
            key = (job.arrival, job.job_id)
            if key < last:
                raise TraceFormatError(
                    f"trace {self.path}: arrivals more than "
                    f"{self.reorder_window} jobs out of order (job "
                    f"{job.job_id} at t={job.arrival:g} after "
                    f"t={last[0]:g} was emitted); raise "
                    f"reorder_window or sort the trace")
            last = key
            if offset is None:
                offset = job.arrival if self.rebase else 0.0
            return self._normalize(job, offset)

        # the file closes when the generator ends, raises, or is closed or
        # collected unfinished (GeneratorExit unwinds the ``with``)
        with f:
            for job in adapter.jobs(rows, self.path):
                heapq.heappush(heap, (job.arrival, job.job_id, job))
                if len(heap) > self.reorder_window:
                    yield emit(heapq.heappop(heap)[2])
            while heap:
                yield emit(heapq.heappop(heap)[2])

    def load(self) -> List[Job]:
        """Eager loader: materialise everything, then sort totally by
        ``(arrival, job_id)`` — no disorder bound, O(n) memory.  The
        streaming reader's differential oracle."""
        f, adapter, rows = self._open()
        with f:
            jobs = list(adapter.jobs(rows, self.path))
        jobs.sort(key=lambda j: (j.arrival, j.job_id))
        offset = (jobs[0].arrival if self.rebase and jobs else 0.0)
        return [self._normalize(j, offset) for j in jobs]

    def _normalize(self, job: Job, offset: float) -> Job:
        if offset:
            job.arrival -= offset
            if job.deadline is not None:
                job.deadline -= offset
        if self.max_gpus is not None and job.num_gpus > self.max_gpus:
            job.num_gpus = self.max_gpus
        return job


# ---------------------------------------------------------------------------
# Windowing: shard a long trace into overlapping job-count windows
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceWindow:
    """One shard of a long trace: ``window_jobs`` consecutive jobs (the
    last window may run short), arrivals rebased so the shard replays
    from t=0.  ``start``/``t0`` keep the provenance (global job index /
    original arrival of the first job)."""

    index: int
    start: int
    t0: float
    jobs: Tuple[Job, ...]


def iter_windows(jobs: Iterable[Job], window_jobs: int,
                 stride_jobs: Optional[int] = None,
                 max_windows: Optional[int] = None) -> Iterator[TraceWindow]:
    """Overlapping job-count windows over a job stream.

    Window *w* covers global job indices ``[w·stride, w·stride +
    window_jobs)`` — ``stride < window`` overlaps shards (rolling
    evaluation), ``stride > window`` samples a long trace.  Streaming:
    at most ``ceil(window/stride)`` windows are buffered, independent of
    trace length.  Each yielded job is a fresh rebased copy, so
    overlapping windows never share mutable ``Job`` state."""
    if window_jobs < 1:
        raise ValueError("window_jobs must be >= 1")
    stride = window_jobs if stride_jobs is None else stride_jobs
    if stride < 1:
        raise ValueError("stride_jobs must be >= 1")
    if max_windows is not None and max_windows < 1:
        raise ValueError("max_windows must be >= 1 (or None)")

    def _close(w: int, start: int, buf: List[Job]) -> TraceWindow:
        t0 = buf[0].arrival
        rebased = tuple(dataclasses.replace(j, arrival=j.arrival - t0,
                                            deadline=None if j.deadline is None
                                            else j.deadline - t0)
                        for j in buf)
        return TraceWindow(index=w, start=start, t0=t0, jobs=rebased)

    active: List[Tuple[int, int, List[Job]]] = []   # (w, start, buffer)
    for i, job in enumerate(jobs):
        # window i // stride opens exactly when its start index arrives
        if i % stride == 0 and (max_windows is None
                                or i // stride < max_windows):
            active.append((i // stride, i, []))
        for entry in list(active):
            w, start, buf = entry
            buf.append(job)
            if len(buf) == window_jobs:
                yield _close(w, start, buf)
                active.remove(entry)
        # stop consuming the stream once every requested window closed
        if (max_windows is not None and not active
                and i // stride + 1 >= max_windows):
            return
    for w, start, buf in active:
        if buf:
            yield _close(w, start, buf)


# ---------------------------------------------------------------------------
# Fitting: measured trace → synthetic WorkloadSpec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceSummary:
    """Single-pass summary of a job stream (bounded memory: size counts
    plus scalar accumulators — safe on million-job traces)."""

    n: int
    span: float                      # last arrival − first arrival
    mean_interarrival: float
    mean_gpus: float
    size_mix: Tuple[Tuple[int, float], ...]   # empirical (size, frac)
    iters_log_mean: float
    iters_log_sigma: float
    gpu_seconds: float


def summarize_jobs(jobs: Iterable[Job]) -> TraceSummary:
    """Stream once, accumulate the :class:`TraceSummary` moments."""
    n = 0
    first = last = 0.0
    sizes: Dict[int, int] = {}
    log_sum = log_sq = 0.0
    gpu_seconds = gpus_sum = 0.0
    for job in jobs:
        if n == 0:
            first = job.arrival
        last = job.arrival
        n += 1
        sizes[job.num_gpus] = sizes.get(job.num_gpus, 0) + 1
        li = math.log(max(1, job.num_iters))
        log_sum += li
        log_sq += li * li
        gpus_sum += job.num_gpus
        gpu_seconds += job.num_gpus * job.ideal_runtime()
    if n == 0:
        return TraceSummary(0, 0.0, 0.0, 0.0, (), 0.0, 0.0, 0.0)
    span = last - first
    var = max(0.0, log_sq / n - (log_sum / n) ** 2)
    mix = tuple((s, sizes[s] / n) for s in sorted(sizes))
    return TraceSummary(
        n=n, span=span,
        mean_interarrival=span / (n - 1) if n > 1 else 0.0,
        mean_gpus=gpus_sum / n, size_mix=mix,
        iters_log_mean=log_sum / n, iters_log_sigma=math.sqrt(var),
        gpu_seconds=gpu_seconds)


def empirical_size_mix(jobs: Iterable[Job]) -> Tuple[Tuple[int, float], ...]:
    """GPU-size mix extraction: the measured ``(size, fraction)`` table,
    directly usable as ``WorkloadSpec.size_mix``."""
    return summarize_jobs(jobs).size_mix


def fit_workload(jobs_or_summary: Union[TraceSummary, Iterable[Job]],
                 **overrides) -> WorkloadSpec:
    """Arrival-process + duration fitting: a synthetic
    :class:`WorkloadSpec` whose Poisson rate, GPU-size mix and lognormal
    iteration distribution match the measured trace — the paired
    synthetic twin for measured-vs-synthetic ablations.  ``overrides``
    pass straight through (e.g. ``seed=1``, ``max_gpus=256``)."""
    s = (jobs_or_summary if isinstance(jobs_or_summary, TraceSummary)
         else summarize_jobs(jobs_or_summary))
    if s.n == 0:
        raise ValueError("cannot fit a workload to an empty trace")
    kwargs = dict(
        num_jobs=s.n,
        mean_interarrival=s.mean_interarrival if s.mean_interarrival > 0
        else 120.0,
        size_mix=s.size_mix,
        iters_log_mean=s.iters_log_mean,
        iters_log_sigma=s.iters_log_sigma,
    )
    kwargs.update(overrides)
    return WorkloadSpec(**kwargs)
