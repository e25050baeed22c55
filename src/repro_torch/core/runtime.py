"""Fault-tolerant campaign execution: retries, timeouts, journal, resume.

The paper-scale campaigns (§9) and everything the ROADMAP stacks on top of
them — million-job trace replay, RL training sweeps — multiply wall time to
the point where "one crash loses the run" is unacceptable.  This module is
the execution layer :func:`repro_torch.core.campaign.run_campaign` drives cells
through:

* :class:`CellRunner` — runs grid cells serially or across a
  ``ProcessPoolExecutor`` with per-cell wall-clock timeouts, bounded
  retries with exponential backoff (seeded, deterministic jitter), crash
  classification (transient worker death / timeout vs. deterministic cell
  error), and optional quarantine of poisoned cells so the rest of the
  grid completes.
* :class:`CellJournal` — an append-only JSONL journal of completed cells
  (schema-fingerprinted header + one exact
  :class:`~repro_torch.core.metrics.MetricsReport` record per cell).  A resumed
  campaign skips journaled cells and merges a result **bit-identical** to
  an uninterrupted run (``tests/test_runtime.py`` pins this property).
* :func:`atomic_write_text` / :func:`atomic_write_bytes` — ``*.tmp`` +
  ``os.replace`` writers shared by every campaign/report artifact, so a
  crash mid-write can never leave a truncated JSON/CSV/SVG behind.

Failure taxonomy (``FailedCell.kind``):

==============  ============================================  ==========
kind            raised as                                     retried?
==============  ============================================  ==========
``crash``       worker process death (``BrokenProcessPool``)  yes
``timeout``     cell exceeded ``SimConfig.cell_timeout``      yes
``transient``   exception in :data:`TRANSIENT_EXCEPTIONS`     yes
``error``       any other exception (deterministic bug)       no
==============  ============================================  ==========

Retryable kinds get ``SimConfig.max_retries`` extra attempts; whatever
still fails is *poisoned*: with ``SimConfig.quarantine`` the cell is
recorded in ``CampaignResult.failed_cells`` and the grid keeps going,
without it a :class:`CampaignError` aborts the campaign (pointing at the
journal, so nothing already computed is lost).

Deterministic fault injection for all of the above lives in
:mod:`repro_torch.testing.chaos`.  Full contract: ``docs/robustness.md``.

The port has no ``try``: a cell's exception is read from the
``concurrent.futures.Future`` that ran it (``fut.exception()``).  Serial
cells run, in grid order and in this process, on one thread the runner
owns; pool workers are started with ``spawn`` (never ``fork``, which
cannot hand a child a usable CUDA context and forks a multi-threaded
process), so a strategy reaches the workers only when an importable module
registers it.  Cleanup that the reference does in ``finally`` blocks runs
from ``contextlib.ExitStack`` callbacks, which clean up and swallow
nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import json
import multiprocessing
import os
import random
import re
import time
from collections import deque
from concurrent.futures import (FIRST_COMPLETED, ProcessPoolExecutor,
                                ThreadPoolExecutor, wait)
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Set, Tuple)

from .config import SimConfig
from .jobs import Job
from .metrics import MetricsReport
from .topology import ClusterSpec

#: exception types classified ``transient`` (infrastructure trouble worth
#: retrying: OOM kills surface as MemoryError/OSError, IPC hiccups as
#: EOFError/ConnectionError).  Anything else is a deterministic cell error:
#: retrying would reproduce it, so it fails fast instead.
TRANSIENT_EXCEPTIONS = (OSError, EOFError, ConnectionError, MemoryError)

#: ceiling on one backoff sleep, seconds
MAX_BACKOFF = 30.0

#: seconds a submitted cell may wait for its spawned worker to begin it
#: before the pool generation counts as crashed (far above an honest spawn:
#: 6–10 s a generation on a card's host, more under a loaded test run)
STARTUP_LIMIT = 120.0

#: pool generations in a row whose workers begin no cell before the run
#: stops instead of rebuilding again
MAX_STALLS = 3

#: key identifying one grid cell: (strategy, scheduler, load, seed)
CellKey = Tuple[str, str, float, int]


class CampaignCell(NamedTuple):
    """One resolved grid cell: identity axes + everything a worker needs."""

    strategy: str
    scheduler: str
    load: float
    seed: int
    spec: ClusterSpec
    trace: List[Job]
    config: SimConfig

    def key(self) -> CellKey:
        return (self.strategy, self.scheduler, self.load, self.seed)


@dataclass
class CellOutcome:
    """A completed cell: the report plus how it got here."""

    report: MetricsReport
    wall_time: float
    attempts: int = 1           # simulation attempts spent (0 = resumed)
    resumed: bool = False       # loaded from the journal, not simulated


@dataclass(frozen=True)
class FailedCell:
    """A quarantined (poisoned) cell — the accounting row
    ``CampaignResult.failed_cells`` carries."""

    strategy: str
    scheduler: str
    load: float
    seed: int
    kind: str                   # "crash" | "timeout" | "transient" | "error"
    error: str                  # human-readable cause
    attempts: int               # attempts spent before giving up

    def key(self) -> CellKey:
        return (self.strategy, self.scheduler, self.load, self.seed)


class CampaignError(RuntimeError):
    """A grid cell failed permanently and quarantine is off.

    Carries the :class:`FailedCell` (``.failed``) and the journal path
    (``.journal``, when the campaign was journaling) so the caller can
    resume instead of recomputing everything."""

    def __init__(self, failed: FailedCell, journal: Optional[str] = None):
        self.failed = failed
        self.journal = journal
        hint = (f"; completed cells are journaled at {journal} — rerun "
                f"with resume={journal!r} to keep them"
                if journal else
                "; pass journal= to make campaigns resumable")
        super().__init__(
            f"campaign cell {failed.key()} failed "
            f"({failed.kind} after {failed.attempts} attempt(s)): "
            f"{failed.error}{hint}.  Set quarantine=True to skip poisoned "
            f"cells and let the rest of the grid complete.")


def classify_exception(exc: BaseException) -> str:
    """``"transient"`` for infrastructure-looking failures (see
    :data:`TRANSIENT_EXCEPTIONS`), ``"error"`` for deterministic ones."""
    return "transient" if isinstance(exc, TRANSIENT_EXCEPTIONS) else "error"


def backoff_delay(seed: int, cell_index: int, attempt: int,
                  base: float) -> float:
    """Exponential backoff with deterministic jitter: the delay before
    retry ``attempt`` (1-based) of cell ``cell_index``.  Jitter is seeded
    by ``(seed, cell_index, attempt)``, so a replayed campaign sleeps the
    identical schedule — chaos tests stay wall-clock-deterministic."""
    if base <= 0.0:
        return 0.0
    raw = base * (2.0 ** max(0, attempt - 1))
    jitter = random.Random(f"{seed}:{cell_index}:{attempt}").random()
    return min(raw * (1.0 + 0.25 * jitter), MAX_BACKOFF)


# ---------------------------------------------------------------------------
# Atomic artifact writes
# ---------------------------------------------------------------------------

def atomic_write_bytes(path, data: bytes) -> None:
    """Write ``path`` via ``path.tmp`` + ``os.replace``: readers (and the
    gates — bench_gate.py, docs_lint.py) can never observe a torn file."""
    path = os.fspath(path)
    tmp = f"{path}.tmp"
    with contextlib.ExitStack() as stack:
        # a failed write leaves no .tmp behind (the error still propagates)
        stack.callback(_remove_if_present, tmp)
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)


def _remove_if_present(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def atomic_write_text(path, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------

def trace_fingerprint(trace: Sequence[Job],
                      events: Sequence = ()) -> str:
    """Stable fingerprint of one cell slice's inputs (job trace + event
    trace).  Two campaigns with equal fingerprints simulate identical
    inputs, so journaled results are interchangeable between them."""
    h = hashlib.sha256()
    for j in trace:
        h.update(repr((j.job_id, j.model, j.num_gpus, j.batch_size,
                       j.arrival, j.num_iters, j.allreduce_algo,
                       j.deadline)).encode())
    for e in events:
        h.update(repr(e).encode())
    return h.hexdigest()[:16]


class JournalMismatch(ValueError):
    """The journal on disk was written for a different campaign."""


#: one JSON token after optional JSON whitespace, as ``json.loads`` reads
#: them (strict strings, ``NaN`` / ``Infinity`` / ``-Infinity`` accepted)
_JSON_TOKEN = re.compile(r'''[ \t\n\r]*(?:
    (?P<open>[\[{]) | (?P<close>[\]}]) | (?P<colon>:) | (?P<comma>,)
  | (?P<value>"(?:[^"\\\x00-\x1f]|\\(?:["\\/bfnrt]|u[0-9a-fA-F]{4}))*"
      | -?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?
      | true | false | null | NaN | Infinity | -Infinity))''', re.VERBOSE)


def is_json(text: str) -> bool:
    """Whether ``json.loads(text)`` parses ``text`` (one JSON document,
    surrounding JSON whitespace allowed): how the port tells a torn journal
    line from a record without catching the decoder's error."""
    stack: List[str] = []
    want = "value"    # value | item (value or "]") | key | member (key or
    pos = 0           # "}") | colon | next ("," or a close) | end
    while True:
        m = _JSON_TOKEN.match(text, pos)
        if m is None:
            return want == "end" and not text[pos:].strip(" \t\n\r")
        pos, kind, tok = m.end(), m.lastgroup, m.group(m.lastgroup)
        if kind == "close" and want in ("item", "member", "next") \
                and stack and stack[-1] == tok \
                and (want != "item" or tok == "]") \
                and (want != "member" or tok == "}"):
            stack.pop()
            want = "next" if stack else "end"
        elif kind == "open" and want in ("value", "item"):
            stack.append("]" if tok == "[" else "}")
            want = "item" if tok == "[" else "member"
        elif kind == "value" and want in ("value", "item"):
            want = "next" if stack else "end"
        elif kind == "value" and want in ("key", "member") \
                and tok.startswith('"'):
            want = "colon"
        elif kind == "colon" and want == "colon":
            want = "value"
        elif kind == "comma" and want == "next":
            want = "value" if stack[-1] == "]" else "key"
        else:
            return False


class LineJournal:
    """Generic append-only JSONL journal: schema-fingerprinted header +
    one record per line, flushed line-atomically.

    This is the shared durability layer behind :class:`CellJournal`
    (campaign cells) and the scheduler daemon's event log
    (:class:`repro_torch.service.state.ServiceLog`).  The contract both
    inherit:

    * line 1 is a ``header`` record carrying a *schema* dict; resuming
      validates it so a journal can never be replayed into a run it was
      not written for,
    * every :meth:`append_record` is one ``json.dumps(..., sort_keys=True)``
      line followed by ``flush()`` — a process crash can at worst leave one
      torn trailing line, which :meth:`open_resume` detects and truncates
      (a torn line anywhere *else* means external corruption and raises),
    * ``fsync=True`` additionally ``os.fsync``\\ s after every flush,
      hardening the log against kernel panics / power loss at the cost of
      one disk barrier per record.  Campaign journals default it off (a
      lost tail record just re-simulates); the scheduler service event log
      turns it on (a lost record there is an acknowledged client request).
    """

    VERSION = 1
    #: label used in the no-header error ("not a campaign journal")
    _LABEL = "campaign"

    def __init__(self, path: str, schema: Dict, fh, fsync: bool = False):
        self.path = path
        self.schema = schema
        self._fh = fh
        self.fsync = fsync
        # cumulative wall time spent serialising + writing records;
        # the ≤5% overhead gate (benchmarks/bench_campaign.py) reads this
        # so the measurement is immune to run-to-run machine noise
        self.io_seconds = 0.0

    # -- construction -------------------------------------------------------
    @staticmethod
    def _normalize(schema: Dict) -> Dict:
        # one canonical form for comparisons: whatever JSON makes of it
        # (tuples -> lists, int-vs-float untouched)
        return json.loads(json.dumps(schema, sort_keys=True))

    def _sync(self) -> None:
        if self.fsync:
            os.fsync(self._fh.fileno())

    @classmethod
    def create(cls, path: str, schema: Dict,
               fsync: bool = False) -> "LineJournal":
        if os.path.exists(path):
            raise ValueError(
                f"journal {path!r} already exists; pass resume={path!r} to "
                f"continue it (or remove the file for a fresh run)")
        schema = cls._normalize(schema)
        fh = open(path, "a")
        fh.write(json.dumps({"kind": "header", "version": cls.VERSION,
                             "schema": schema}, sort_keys=True) + "\n")
        fh.flush()
        jr = cls(path, schema, fh, fsync=fsync)
        jr._sync()
        return jr

    @classmethod
    def open_resume(cls, path: str, schema: Dict, fsync: bool = False,
                    ) -> Tuple["LineJournal", List[Dict]]:
        """Open an existing journal, validate its schema, and return
        ``(journal, records)`` — the parsed body records (header excluded),
        with any torn trailing line truncated off the file."""
        if not os.path.exists(path):
            raise ValueError(f"resume journal {path!r} does not exist; "
                             f"pass journal= for a fresh run")
        schema = cls._normalize(schema)
        with open(path, "rb") as f:
            raw = f.read()
        # split on the writer's own terminator (records are one "\n"-ended
        # line each) so every segment's byte offset is exact — needed to
        # truncate a torn tail below
        segments = raw.split(b"\n")
        records = []
        torn_at: Optional[int] = None   # byte offset where a torn tail starts
        offset = 0
        for n, seg in enumerate(segments):
            line = seg.decode("utf-8", errors="replace")
            if line.strip():
                if not is_json(line):
                    if n == len(segments) - 1:
                        # torn tail: the crash interrupted the final append —
                        # drop it, that record replays/re-simulates
                        torn_at = offset
                        break
                    raise ValueError(
                        f"journal {path!r} is corrupt at line {n + 1} (only "
                        f"the final line may be torn); refusing to resume")
                records.append(json.loads(line))
            offset += len(seg) + 1
        if not records or records[0].get("kind") != "header":
            raise JournalMismatch(
                f"journal {path!r} has no header record — not a "
                f"{cls._LABEL} journal (or truncated before the first "
                f"flush)")
        head = records[0]
        if head.get("version") != cls.VERSION:
            raise JournalMismatch(
                f"journal {path!r} is version {head.get('version')}, "
                f"this runtime writes version {cls.VERSION}")
        theirs = head.get("schema", {})
        if theirs != schema:
            diffs = [k for k in sorted(set(theirs) | set(schema))
                     if theirs.get(k) != schema.get(k)]
            raise JournalMismatch(
                f"journal {path!r} was written for a different "
                f"{cls._LABEL} (differing schema keys: {', '.join(diffs)}); "
                f"point resume= at the matching journal or start fresh")
        if torn_at is not None:
            # chop the torn bytes off before reopening for append: without
            # this the next record would concatenate onto the partial line,
            # planting mid-file corruption that poisons the *next* resume
            with open(path, "r+b") as f:
                f.truncate(torn_at)
        fh = open(path, "a")
        if torn_at is None and raw and not raw.endswith(b"\n"):
            # final record is complete but its terminator never hit disk
            # (torn between the JSON and the "\n"): restore the newline so
            # the next append starts a fresh line
            fh.write("\n")
            fh.flush()
        jr = cls(path, schema, fh, fsync=fsync)
        return jr, records[1:]

    # -- appends ------------------------------------------------------------
    def append_record(self, rec: Dict) -> None:
        t0 = time.perf_counter()
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()
        self._sync()
        self.io_seconds += time.perf_counter() - t0

    def close(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()


class CellJournal(LineJournal):
    """Append-only JSONL journal of completed campaign cells.

    Line 1 is a ``header`` record carrying the campaign *schema* (grid
    axes, cluster dims, store mode, per-slice trace fingerprints, the
    result-affecting config knobs).  Every subsequent line is one ``cell``
    record: the cell key, its wall time, and the **exact**
    :meth:`MetricsReport.to_journal` payload — floats survive JSON via
    shortest-round-trip repr, so a loaded report is bit-identical to the
    simulated one.

    Durability contract: records are flushed line-atomically after every
    cell (``fsync=True`` upgrades that to a disk barrier per record — see
    :class:`LineJournal`).  A crash can at worst leave one torn trailing
    line, which :meth:`resume` detects and drops (that cell is simply
    re-simulated).

    The simulator engine is deliberately **not** part of the schema:
    v1/v2/batched are bit-identical by contract (``tests/test_batched.py``,
    ``tests/test_campaign.py``), so a journal written under one engine may
    be resumed under another."""

    @classmethod
    def resume(cls, path: str, schema: Dict, fsync: bool = False,
               ) -> Tuple["CellJournal", Dict[CellKey, Tuple[MetricsReport,
                                                             float]]]:
        """Open an existing journal, validate its schema against the
        current campaign, and return ``(journal, completed)`` where
        ``completed`` maps cell keys to their journaled reports."""
        jr, records = cls.open_resume(path, schema, fsync=fsync)
        completed: Dict[CellKey, Tuple[MetricsReport, float]] = {}
        for rec in records:
            if rec.get("kind") != "cell":
                continue
            s, q, load, seed = rec["cell"]
            key = (str(s), str(q), float(load), int(seed))
            completed[key] = (MetricsReport.from_journal(rec["report"]),
                              float(rec["wall_time"]))
        return jr, completed

    def append(self, key: CellKey, report: MetricsReport,
               wall_time: float) -> None:
        self.append_record({"kind": "cell", "cell": list(key),
                            "wall_time": wall_time,
                            "report": report.to_journal()})


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

class CellRunner:
    """Drives campaign cells to completion under the fault policy of their
    :class:`SimConfig` (``cell_timeout`` / ``max_retries`` /
    ``retry_backoff`` / ``quarantine``).

    Two modes share one policy:

    * :meth:`run_serial` — in-process, grid order.  Retries transient
      exceptions with backoff; cannot preempt a hung cell (no timeouts)
      and cannot survive a hard crash of the interpreter — pool mode
      covers both.
    * :meth:`run_pool` — a ``ProcessPoolExecutor`` with *windowed
      submission* (at most ``workers`` cells in flight, so a submitted
      cell starts immediately and its deadline is honest).  Worker death
      (``BrokenProcessPool``) kills every in-flight future, and a
      submission the broken pool refuses is requeued; when more
      than one cell was in flight the culprit is unknown, so the runner
      enters *isolation mode* — suspects re-run one at a time until the
      poisoned cell identifies itself (innocent cells complete and are
      journaled; the culprit's crash is then attributed and retried /
      quarantined) — after which full parallelism resumes.  Hung cells
      past their deadline get the whole pool killed (a hung worker cannot
      be interrupted any other way) and the innocents resubmitted without
      an attempt penalty.

      A cell's deadline is ``cell_timeout`` from the moment its worker
      *begins* it, not from submission: workers are spawned, and a fresh
      worker pays for an interpreter and its imports before its first
      cell (6–10 s a pool generation on a card's host), which the
      reference's forked workers never do.  Each pool generation hands
      its workers a start-notice queue (:class:`_SpawnPool`), and
      :func:`_begin_cell` puts ``(token, time.monotonic())`` on it before
      the cell runs (``CLOCK_MONOTONIC`` is system-wide).  Start-up has
      a limit of its own, :data:`STARTUP_LIMIT`, with or without a
      ``cell_timeout``: a cell that has not
      begun that long after its submission means the generation's
      workers did not start, which is handled as a crash of the
      generation — the pool is rebuilt and every in-flight cell goes back
      without an attempt penalty (after :data:`MAX_STALLS` generations in
      a row with no cell begun, the campaign stops with a
      ``RuntimeError``).

    Completed cells are journaled the moment they finish — in either
    mode, whatever completed before a crash survives it."""

    def __init__(self, cells: Sequence[CampaignCell], config: SimConfig,
                 run_cell: Callable[..., Tuple[MetricsReport, float]],
                 journal: Optional[CellJournal] = None,
                 progress: Optional[Callable[[str], None]] = None):
        self.cells = list(cells)
        self.config = config
        self._run_cell = run_cell
        self.journal = journal
        self.progress = progress

    # -- shared plumbing ----------------------------------------------------
    def _note(self, cell: CampaignCell, rep: MetricsReport, dt: float,
              suffix: str = "") -> None:
        if self.progress is not None:
            self.progress(
                f"[campaign] {cell.strategy}/{cell.scheduler} "
                f"λ={cell.load:g} seed={cell.seed}: JCT {rep.avg_jct:.1f}s "
                f"(n={rep.n_finished}) in {dt:.2f}s{suffix}")

    def _complete(self, i: int, rep: MetricsReport, dt: float,
                  attempts: int, results: Dict[int, CellOutcome],
                  suffix: str = "") -> None:
        results[i] = CellOutcome(rep, dt, attempts=attempts)
        if self.journal is not None:
            self.journal.append(self.cells[i].key(), rep, dt)
        self._note(self.cells[i], rep, dt, suffix)

    def _give_up(self, i: int, kind: str, error: str, attempts: int,
                 failed: Dict[int, FailedCell],
                 cause: Optional[BaseException] = None) -> None:
        """Quarantine the poisoned cell or abort the campaign."""
        cell = self.cells[i]
        fc = FailedCell(cell.strategy, cell.scheduler, cell.load, cell.seed,
                        kind=kind, error=error, attempts=attempts)
        if self.config.quarantine:
            failed[i] = fc
            if self.progress is not None:
                self.progress(f"[campaign] QUARANTINED {fc.key()} "
                              f"({kind} after {attempts} attempt(s)): "
                              f"{error}")
            return
        raise CampaignError(
            fc, self.journal.path if self.journal else None) from cause

    def _backoff(self, i: int, attempt: int) -> None:
        d = backoff_delay(self.config.seed, i, attempt,
                          self.config.retry_backoff)
        if d > 0.0:
            time.sleep(d)

    # -- serial mode --------------------------------------------------------
    def run_serial(self, indices: Sequence[int],
                   ) -> Tuple[Dict[int, CellOutcome], Dict[int, FailedCell]]:
        """Run ``indices`` in grid order in this process.  Each attempt runs
        on one thread the runner owns, so its exception comes back from the
        future; a ``KeyboardInterrupt`` (or any other non-``Exception``)
        raised by the cell propagates, as the reference's ``except
        KeyboardInterrupt: raise`` does."""
        results: Dict[int, CellOutcome] = {}
        failed: Dict[int, FailedCell] = {}
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="campaign-cell") as runner:
            for i in indices:
                cell = self.cells[i]
                attempt = 0
                while True:
                    fut = runner.submit(self._run_cell, cell.spec,
                                        cell.trace, cell.config, i, attempt)
                    e = fut.exception()
                    if e is None:
                        rep, dt = fut.result()
                        self._complete(i, rep, dt, attempt + 1, results)
                        break
                    if not isinstance(e, Exception):
                        raise e
                    attempt += 1
                    kind = classify_exception(e)
                    if kind == "transient" \
                            and attempt <= self.config.max_retries:
                        self._backoff(i, attempt)
                        continue
                    self._give_up(i, kind, f"{type(e).__name__}: {e}",
                                  attempt, failed, cause=e)
                    break
        return results, failed

    # -- pool mode ----------------------------------------------------------
    def run_pool(self, indices: Sequence[int],
                 ) -> Tuple[Dict[int, CellOutcome], Dict[int, FailedCell]]:
        cfg = self.config
        workers = max(1, cfg.workers or 1)
        timeout = cfg.cell_timeout if cfg.cell_timeout > 0 else None
        results: Dict[int, CellOutcome] = {}
        failed: Dict[int, FailedCell] = {}
        attempts: Dict[int, int] = {i: 0 for i in indices}
        queue = deque(indices)
        suspects: Set[int] = set()     # in flight at an unattributed crash
        inflight: Dict[object, _Flight] = {}
        tokens = itertools.count()
        stalls = 0                     # generations in a row that began nothing
        pool = _spawn_pool(workers)
        ok = False

        def submit(i: int) -> bool:
            """Hand cell ``i`` to the pool; ``False`` when the pool turned
            out broken.  A worker can die after ``wait`` returned other
            futures, and ``ProcessPoolExecutor.submit`` then raises: the
            submission runs on the runner's own thread so that failure
            comes back from a future.  The cell goes back to the head of
            the queue without penalty; the in-flight futures were already
            failed with the pool and are collected as a crash."""
            c = self.cells[i]
            token = next(tokens)
            sub = submitter.submit(pool.submit, _begin_cell, token,
                                   self._run_cell, c.spec, c.trace, c.config,
                                   i, attempts[i])
            e = sub.exception()
            if e is None:
                inflight[sub.result()] = _Flight(i, token, time.monotonic(),
                                                 None)
                return True
            if not isinstance(e, BrokenProcessPool):
                raise e
            queue.appendleft(i)
            return False

        def read_notices() -> None:
            """Record the begin time of every cell whose start notice has
            arrived; drained every turn, so no worker blocks on a full
            pipe."""
            nonlocal stalls
            by_token = {fl.token: fl for fl in inflight.values()}
            while not pool.notices.empty():
                token, t = pool.notices.get()
                fl = by_token.get(token)
                if fl is not None and fl.begun is None:
                    fl.begun = t
                    stalls = 0

        def wake_in(now: float) -> Optional[float]:
            """Seconds until the next deadline can fall due: a cell not yet
            begun has its start-up limit, which runs from its submission,
            and cannot expire before ``cell_timeout`` from now (it begins
            after this turn's notices were read); a begun one expires
            ``cell_timeout`` after it began.  None when nothing can fall
            due (every cell begun, no ``cell_timeout``)."""
            due = []
            for fl in inflight.values():
                if fl.begun is None:
                    due.append(fl.submitted + STARTUP_LIMIT)
                if timeout is not None:
                    due.append(now + timeout if fl.begun is None
                               else fl.begun + timeout)
            return max(0.0, min(due) - now) if due else None

        def rebuild() -> None:
            nonlocal pool
            _shutdown_pool(pool, kill=True)
            pool = _spawn_pool(workers)

        def retry_or_give_up(i: int, kind: str, error: str,
                             cause: Optional[BaseException] = None) -> None:
            attempts[i] += 1
            suspects.discard(i)
            if attempts[i] <= cfg.max_retries:
                self._backoff(i, attempts[i])
                queue.appendleft(i)    # retries run before fresh cells
            else:
                self._give_up(i, kind, error, attempts[i], failed,
                              cause=cause)

        with contextlib.ExitStack() as stack:
            # KeyboardInterrupt / CampaignError / anything else: cancel
            # outstanding futures and kill the workers so nothing leaks
            # (the journal already holds every completed cell)
            stack.callback(lambda: _shutdown_pool(pool, kill=not ok))
            submitter = stack.enter_context(ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="campaign-submit"))
            while queue or inflight:
                # isolation mode: one cell in flight, suspects first, so a
                # repeat crash identifies the poisoned cell unambiguously
                cap = 1 if suspects else workers
                if suspects and not inflight:
                    for s in sorted(suspects, reverse=True):
                        if s in queue:
                            queue.remove(s)
                            queue.appendleft(s)
                while queue and len(inflight) < cap:
                    if submit(queue.popleft()):
                        continue
                    if inflight:
                        break          # their crash is collected below
                    rebuild()          # a worker died idle: nothing lost
                read_notices()
                done, _ = wait(set(inflight),
                               timeout=wake_in(time.monotonic()),
                               return_when=FIRST_COMPLETED)
                if not done:
                    # futures can finish between wait() timing out and the
                    # expiry scan below; harvest them through the normal
                    # done path (success / exception / crash alike) instead
                    # of throwing the finished work away with the pool kill
                    done = {f for f in inflight if f.done()}

                if not done:
                    # a deadline expired with the worker still grinding: a
                    # hung worker cannot be interrupted, so the whole pool
                    # is killed; innocents resubmit without penalty.  A
                    # cell still waiting for its worker past the start-up
                    # limit means the generation never started: the same
                    # kill, with nobody to blame
                    read_notices()
                    now = time.monotonic()
                    hung = {fl.i for fl in inflight.values()
                            if timeout is not None and fl.begun is not None
                            and now >= fl.begun + timeout - 1e-9}
                    stalled = [fl.i for fl in inflight.values()
                               if fl.begun is None
                               and now >= fl.submitted + STARTUP_LIMIT]
                    if not hung and not stalled:
                        continue
                    innocents = [fl.i for fl in inflight.values()
                                 if fl.i not in hung]
                    inflight.clear()
                    if not hung:
                        stalls += 1
                        if stalls >= MAX_STALLS:
                            raise RuntimeError(
                                f"{stalls} pool generations in a row began "
                                f"no cell within STARTUP_LIMIT="
                                f"{STARTUP_LIMIT:g}s of its submission: "
                                f"spawned workers do not start")
                    rebuild()
                    for i in innocents:
                        queue.appendleft(i)
                    for i in sorted(hung):
                        retry_or_give_up(
                            i, "timeout",
                            f"cell exceeded cell_timeout="
                            f"{cfg.cell_timeout:g}s (worker killed)")
                    continue

                crashed: List[int] = []
                for fut in done:
                    i = inflight.pop(fut).i
                    e = fut.exception()
                    if e is None:
                        rep, dt = fut.result()
                        self._complete(i, rep, dt, attempts[i] + 1, results)
                        suspects.discard(i)
                    elif isinstance(e, BrokenProcessPool):
                        crashed.append(i)
                    elif isinstance(e, Exception):
                        retry_or_give_up(i, classify_exception(e),
                                         f"{type(e).__name__}: {e}",
                                         cause=e)
                    else:
                        raise e

                if crashed:
                    # the pool is dead — every other in-flight future is
                    # doomed with it; collect them before rebuilding
                    doomed = [fl.i for fl in inflight.values()]
                    inflight.clear()
                    rebuild()
                    everyone = crashed + doomed
                    if len(everyone) == 1:
                        # unambiguous: the lone in-flight cell killed its
                        # worker — transient worker death, retryable
                        retry_or_give_up(
                            everyone[0], "crash",
                            "worker process died (BrokenProcessPool — "
                            "OOM kill / segfault / os._exit)")
                    else:
                        # ambiguous: isolate — resubmit the in-flight set
                        # one at a time (no attempt penalty: all but one
                        # are innocent)
                        suspects.update(everyone)
                        for i in sorted(everyone, reverse=True):
                            queue.appendleft(i)
            ok = True
        return results, failed


@dataclass
class _Flight:
    """One submitted cell: its grid index, the token its start notice
    carries, when it was submitted and when its worker began it (``None``
    until the notice arrives), all on ``time.monotonic()``."""

    i: int
    token: int
    submitted: float
    begun: Optional[float]


class _SpawnPool(ProcessPoolExecutor):
    """A ``spawn`` process pool whose workers report on :attr:`notices`
    (a ``SimpleQueue`` of this generation alone) when they begin a cell.
    A killed generation's queue goes with it, so a notice can never reach
    the next one."""

    def __init__(self, workers: int):
        ctx = multiprocessing.get_context("spawn")
        self.notices = ctx.SimpleQueue()
        super().__init__(max_workers=workers, mp_context=ctx,
                         initializer=_worker_init, initargs=(self.notices,))


#: the worker's start-notice queue, set by :func:`_worker_init`
_notices = None


def _worker_init(notices) -> None:
    """Runs once in each spawned worker before it takes a cell."""
    global _notices
    _notices = notices
    if os.environ.get("REPRO_CHAOS_STARTUP"):
        from ..testing.chaos import startup_hook
        startup_hook()


def _begin_cell(token: int, run_cell: Callable, *args):
    """The pool's task: post the start notice, then run the cell.  By now
    the worker has started and imported the cell's module (unpickling the
    task does that), so the deadline counts only the cell's own run."""
    _notices.put((token, time.monotonic()))
    return run_cell(*args)


def _spawn_pool(workers: int) -> ProcessPoolExecutor:
    """A process pool whose workers start with ``spawn``: each imports the
    cell function's module afresh, so no worker inherits a CUDA context or
    the parent's threads (``fork`` gives neither safely)."""
    return _SpawnPool(workers)


def _shutdown_pool(pool, kill: bool) -> None:
    """Shut a ``ProcessPoolExecutor`` down without deadlocking: cancel
    whatever never started, and when ``kill`` terminate the worker
    processes outright (the only way to stop a hung or wedged cell).  Only
    live workers are signalled: a worker that already died (a crashed
    cell) needs nothing, and ``shutdown`` then joins without waiting when
    ``kill``."""
    if kill:
        for p in list((getattr(pool, "_processes", None) or {}).values()):
            if p.is_alive():
                p.terminate()
    pool.shutdown(wait=not kill, cancel_futures=True)


# ---------------------------------------------------------------------------
# Campaign journal schema
# ---------------------------------------------------------------------------

def journal_schema(spec: ClusterSpec, ocs_spec: Optional[ClusterSpec],
                   grid, config: SimConfig,
                   cells: Sequence[CampaignCell]) -> Dict:
    """The resume contract: everything that changes cell *results* (grid
    axes, cluster dims, store mode, per-slice input fingerprints, the
    result-affecting config knobs).  The engine is excluded on purpose —
    engines are bit-identical by contract, so journals are portable
    across them."""
    def dims(s: ClusterSpec):
        return {"num_gpus": s.num_gpus, "num_leafs": s.num_leafs,
                "num_spines": s.num_spines, "num_ocs": s.num_ocs}

    fps: Dict[str, str] = {}
    for cell in cells:
        k = f"load={cell.load:g},seed={cell.seed}"
        if k not in fps:
            fps[k] = trace_fingerprint(cell.trace, cell.config.events)
    return {
        "version": CellJournal.VERSION,
        "grid": dataclasses.asdict(grid),
        "cluster": dims(spec),
        "ocs_cluster": dims(ocs_spec) if ocs_spec is not None else None,
        "store": config.store,
        "config": {"ilp_time_limit": config.ilp_time_limit,
                   "max_time": (None if config.max_time == float("inf")
                                else config.max_time),
                   "defrag_interval": config.defrag_interval,
                   "migration_iters": config.migration_iters},
        "traces": fps,
    }
