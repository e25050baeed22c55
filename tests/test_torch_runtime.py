"""Port vs reference: the fault-tolerant campaign runtime
(``repro_torch.core.runtime``) and its chaos harness
(``repro_torch.testing.chaos``).

Twins of ``tests/test_runtime.py`` (its figure tests wait for the figures
slice): the same grid on ``device="cpu"`` must crash, hang, retry,
quarantine and resume to a result bit-identical to an uninterrupted run.
The port has no ``try``, so the journal tells a torn line from a record by
validating it (``runtime.is_json``), serial cells run on one runner-owned
thread, and pool workers are spawned; the tables below hold those rewrites
to the reference's behaviour.
"""

import dataclasses
import json
import multiprocessing
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.testing.chaos as RC  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import runtime as TR  # noqa: E402
from repro_torch.core.metrics import MetricsReport  # noqa: E402
from repro_torch.testing import chaos as TC  # noqa: E402
from repro_torch.testing.chaos import (ChaosError, TransientChaosError,  # noqa: E402
                                       chaos_hook, parse_chaos)

GRID = T.CampaignGrid(strategies=("ecmp", "sr"), loads=(120.0,),
                      seeds=(0, 1))
WL = T.WorkloadSpec(num_jobs=30, max_gpus=64)
# retry_backoff=0: recovery paths shouldn't sleep in CI
FAST = dict(retry_backoff=0.0)


def run(**kw):
    cfg = T.SimConfig(**{**FAST, **kw.pop("cfg", {})})
    return T.run_campaign(T.CLUSTER512, GRID, workload=WL, config=cfg,
                          device="cpu", **kw)


def cell_reports(res):
    return [(c.strategy, c.scheduler, c.load, c.seed, c.report)
            for c in res.cells]


def table_no_wall(res):
    return [{k: v for k, v in row.items() if k != "sim_seconds"}
            for row in res.aggregate()]


@pytest.fixture(scope="module")
def clean():
    return run()


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the comparison is the point
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# units: classification, backoff, chaos grammar, atomic writes
# ---------------------------------------------------------------------------

def test_classify_exception():
    assert T.classify_exception(OSError("boom")) == "transient"
    assert T.classify_exception(EOFError()) == "transient"
    assert T.classify_exception(MemoryError()) == "transient"
    assert T.classify_exception(ConnectionResetError()) == "transient"
    assert T.classify_exception(TransientChaosError("x")) == "transient"
    assert T.classify_exception(ValueError("bug")) == "error"
    assert T.classify_exception(ChaosError("x")) == "error"
    assert TR.TRANSIENT_EXCEPTIONS == R.runtime.TRANSIENT_EXCEPTIONS


def test_backoff_deterministic_bounded():
    d1 = T.backoff_delay(7, 3, 1, base=0.1)
    assert d1 == T.backoff_delay(7, 3, 1, base=0.1)
    assert d1 != T.backoff_delay(7, 3, 2, base=0.1)
    assert 0.1 <= d1 <= 0.125
    d2 = T.backoff_delay(7, 3, 2, base=0.1)
    assert 0.2 <= d2 <= 0.25
    assert T.backoff_delay(0, 0, 50, base=1.0) <= 30.0
    assert T.backoff_delay(0, 0, 1, base=0.0) == 0.0
    for seed, i, a, base in [(7, 3, 1, 0.1), (0, 0, 50, 1.0), (5, 9, 4, 2.0),
                             (1, 2, 0, 0.5), (3, 3, 3, 0.0)]:
        assert T.backoff_delay(seed, i, a, base) == \
            R.backoff_delay(seed, i, a, base)


def test_parse_chaos_grammar():
    rules = parse_chaos("crash@3,flaky@7:2, hang@12 ,raise@0:1")
    assert [(r.kind, r.cell, r.attempts) for r in rules] == [
        ("crash", 3, None), ("flaky", 7, 2), ("hang", 12, None),
        ("raise", 0, 1)]
    assert rules[1].fires(7, 0) and rules[1].fires(7, 1)
    assert not rules[1].fires(7, 2) and not rules[1].fires(6, 0)
    for bad in ("boom@1", "crash", "crash@x", "crash@-1", "crash@1:0"):
        with pytest.raises(ValueError):
            parse_chaos(bad)


#: valid and invalid rule strings; the port parses without ``try`` and
#: must give the reference's rules or its ValueError text
CHAOS_SPECS = [
    "crash@3,flaky@7:2, hang@12 ,raise@0:1", "boom@1", "crash", "crash@x",
    "crash@-1", "crash@1:0", "crash@", "crash@1:", "crash@1:x",
    "crash@ 2 : 3", "raise@1_0", "flaky@٣", "crash@1:2:3", "@1", "crash@+1",
    "crash@1e2", ",,", "hang@2:-0", "", "raise@1__0", "raise@0x1",
    "flaky@3:٢", "crash@1 ,boom@2", "raise@ ", "hang@7:+2",
]


@pytest.mark.parametrize("spec", CHAOS_SPECS, ids=repr)
def test_parse_chaos_matches_reference(spec):
    got, want = _outcome(TC.parse_chaos, spec), _outcome(RC.parse_chaos, spec)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert [tuple(r) for r in got[1]] == [tuple(r) for r in want[1]]
    else:
        assert got[1] == want[1]


def test_chaos_surface_matches_reference():
    assert (TC.ENV_VAR, TC.ENV_HANG, TC.KINDS) == \
        (RC.ENV_VAR, RC.ENV_HANG, RC.KINDS)
    assert issubclass(TC.ChaosError, RuntimeError)
    assert issubclass(TC.TransientChaosError, OSError)


def test_chaos_crash_refused_in_main_process(monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "crash@0")
    with pytest.raises(RuntimeError, match="refused"):
        chaos_hook(0, 0)


def test_atomic_write_text(tmp_path):
    p = tmp_path / "out.json"
    T.atomic_write_text(p, "first")
    T.atomic_write_text(p, "second")
    assert p.read_text() == "second"
    assert list(tmp_path.iterdir()) == [p]


def test_atomic_write_failure_leaves_no_tmp(tmp_path):
    """The reference removes the .tmp in ``finally``; the port's ExitStack
    callback must too, and the error must still propagate."""
    target = tmp_path / "dir-in-the-way"
    target.mkdir()
    (target / "child").write_text("x")
    with pytest.raises(OSError):
        T.atomic_write_text(target, "data")       # os.replace onto a dir
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dir-in-the-way"]


# ---------------------------------------------------------------------------
# journal: round-trip exactness, schema guard, torn-tail tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("condense", [False, True])
def test_metrics_journal_roundtrip_exact(condense):
    rep = T.simulate(T.CLUSTER512, T.generate_trace(WL.with_seed(3)), "ecmp",
                     device="cpu")
    rep.event_log = [(0.0, "preempt", 1, -1, 2)]
    if condense:
        rep.condense(max_samples=16)
    back = MetricsReport.from_journal(
        json.loads(json.dumps(rep.to_journal())))
    assert back == rep
    assert back.event_log == rep.event_log
    assert all(isinstance(e, tuple) for e in back.event_log)


def test_journal_create_refuses_existing(tmp_path):
    p = str(tmp_path / "j.jsonl")
    T.CellJournal.create(p, {"v": 1}).close()
    with pytest.raises(ValueError, match="resume"):
        T.CellJournal.create(p, {"v": 1})


def test_journal_schema_mismatch(tmp_path):
    p = str(tmp_path / "j.jsonl")
    T.CellJournal.create(p, {"grid": [1, 2], "store": "full"}).close()
    with pytest.raises(T.JournalMismatch, match="store"):
        T.CellJournal.resume(p, {"grid": [1, 2], "store": "stream"})
    jr, completed = T.CellJournal.resume(p, {"grid": (1, 2),
                                             "store": "full"})
    jr.close()
    assert completed == {}


def test_journal_torn_tail_dropped_midfile_corruption_raises(tmp_path):
    p = str(tmp_path / "j.jsonl")
    jr = T.CellJournal.create(p, {"v": 1})
    rep = MetricsReport(1.0, 2.0, 3.0, 0.0, 0.0, 1)
    jr.append(("ecmp", "fifo", 120.0, 0), rep, 0.5)
    jr.append(("sr", "fifo", 120.0, 0), rep, 0.5)
    jr.close()
    with open(p, "a") as f:
        f.write('{"kind": "cell", "cell": ["ecmp", "fifo"')
    jr2, completed = T.CellJournal.resume(p, {"v": 1})
    jr2.close()
    assert set(completed) == {("ecmp", "fifo", 120.0, 0),
                              ("sr", "fifo", 120.0, 0)}
    assert completed[("sr", "fifo", 120.0, 0)][0] == rep
    lines = open(p).read().splitlines()
    assert all(json.loads(line) for line in lines)
    lines.insert(1, '{"kind": "cell", "cell": ["ecmp", "fifo"')
    open(p, "w").write("\n".join(lines))
    with pytest.raises(ValueError, match="corrupt at line 2"):
        T.CellJournal.resume(p, {"v": 1})


def test_journal_torn_tail_truncated_then_reappend(tmp_path):
    p = str(tmp_path / "j.jsonl")
    jr = T.CellJournal.create(p, {"v": 1})
    rep = MetricsReport(1.0, 2.0, 3.0, 0.0, 0.0, 1)
    jr.append(("ecmp", "fifo", 120.0, 0), rep, 0.5)
    jr.close()
    with open(p, "a") as f:
        f.write('{"kind": "cell", "cell": ["sr", "fifo"')
    jr2, completed = T.CellJournal.resume(p, {"v": 1})
    assert set(completed) == {("ecmp", "fifo", 120.0, 0)}
    jr2.append(("sr", "fifo", 120.0, 0), rep, 0.5)
    jr2.close()
    jr3, completed = T.CellJournal.resume(p, {"v": 1})
    jr3.close()
    assert set(completed) == {("ecmp", "fifo", 120.0, 0),
                              ("sr", "fifo", 120.0, 0)}
    assert completed[("sr", "fifo", 120.0, 0)][0] == rep


def test_journal_missing_final_newline_restored(tmp_path):
    p = str(tmp_path / "j.jsonl")
    jr = T.CellJournal.create(p, {"v": 1})
    rep = MetricsReport(1.0, 2.0, 3.0, 0.0, 0.0, 1)
    jr.append(("ecmp", "fifo", 120.0, 0), rep, 0.5)
    jr.close()
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 1)
    jr2, completed = T.CellJournal.resume(p, {"v": 1})
    assert set(completed) == {("ecmp", "fifo", 120.0, 0)}
    jr2.append(("sr", "fifo", 120.0, 0), rep, 0.5)
    jr2.close()
    jr3, completed = T.CellJournal.resume(p, {"v": 1})
    jr3.close()
    assert set(completed) == {("ecmp", "fifo", 120.0, 0),
                              ("sr", "fifo", 120.0, 0)}


def test_journal_fsync_opt_in(tmp_path, monkeypatch):
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync",
                        lambda fd: (calls.append(fd), real_fsync(fd))[1])
    rep = MetricsReport(1.0, 2.0, 3.0, 0.0, 0.0, 1)
    jr = T.CellJournal.create(str(tmp_path / "flush.jsonl"), {"v": 1})
    jr.append(("ecmp", "fifo", 120.0, 0), rep, 0.5)
    jr.close()
    assert calls == []
    jr = T.CellJournal.create(str(tmp_path / "sync.jsonl"), {"v": 1},
                              fsync=True)
    assert len(calls) == 1
    jr.append(("ecmp", "fifo", 120.0, 0), rep, 0.5)
    jr.append(("sr", "fifo", 120.0, 0), rep, 0.5)
    assert len(calls) == 3
    jr.close()
    jr2, completed = T.CellJournal.resume(str(tmp_path / "sync.jsonl"),
                                          {"v": 1}, fsync=True)
    assert len(completed) == 2
    n = len(calls)
    jr2.append(("ecmp", "ff", 120.0, 0), rep, 0.5)
    assert len(calls) == n + 1
    jr2.close()


def test_journal_bytes_match_reference(tmp_path):
    """Header and records are the reference's bytes, so either package
    resumes the other's journal."""
    rep = T.simulate(T.CLUSTER512, T.generate_trace(WL.with_seed(2)), "sr",
                     device="cpu")
    paths = []
    for pkg, report in ((T, rep), (R, R.MetricsReport.from_journal(
            rep.to_journal()))):
        p = str(tmp_path / f"{pkg.__name__}.jsonl")
        jr = pkg.CellJournal.create(p, {"grid": (1, 2), "v": 1.5})
        jr.append(("sr", "fifo", 120.0, 0), report, 0.25)
        jr.close()
        paths.append(p)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


#: lines a journal may hold: records, their torn prefixes and junk; the
#: port's validator must split them as ``json.loads`` does
def _journal_lines():
    rep = MetricsReport(1.0, 2.5e-3, float("inf"), 0.0, 0.0, 1)
    rec = json.dumps({"kind": "cell", "cell": ["ecmp", "fifo", 120.0, 0],
                      "wall_time": 0.5, "report": rep.to_journal()},
                     sort_keys=True)
    lines = [rec[:i] for i in range(0, len(rec) + 1, 3)] + [rec]
    lines += ['[]', '{}', '1', '"s"', ' [1 ,2 ] ', '-0.5E+3', '"\\u00e9"',
              '01', '[1,]', '{"a":1,}', '{1:2}', '[1 2]', '"\x01"', "'a'",
              'nan', 'NaN', '-Infinity', '+1', '.5', '1.', '{"a":1}}',
              '[}', 'tru', '"\\x"', '﻿{}', '{"a": {"b": [1, {"c": null}]}}']
    return lines


def test_is_json_matches_json_loads():
    for line in _journal_lines():
        assert TR.is_json(line) == (_outcome(json.loads, line)[0] == "ok"), \
            repr(line)
    rng = np.random.default_rng(1)
    alphabet = ['{', '}', '[', ']', ':', ',', '"a"', '1', '-2.5e3', 'null',
                'true', 'NaN', ' ', '"', '\\', 'x', '0', '.', 'e']
    for _ in range(20000):
        n = int(rng.integers(0, 9))
        s = "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet),
                                                           n))
        assert TR.is_json(s) == (_outcome(json.loads, s)[0] == "ok"), repr(s)


# ---------------------------------------------------------------------------
# serial campaigns: resume bit-identity, retries, quarantine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["full", "stream"])
def test_crash_at_cell_resume_bit_identical_serial(clean, tmp_path,
                                                   monkeypatch, store):
    jp = str(tmp_path / "c.jsonl")
    monkeypatch.setenv("REPRO_CHAOS", "raise@2")
    with pytest.raises(T.CampaignError) as ei:
        run(journal=jp, cfg=dict(store=store))
    assert ei.value.failed.kind == "error"
    assert jp in str(ei.value)
    monkeypatch.delenv("REPRO_CHAOS")
    res = run(resume=jp, cfg=dict(store=store))
    base = run(cfg=dict(store=store)) if store != "full" else clean
    assert res.resumed_cells == 2
    assert cell_reports(res) == cell_reports(base)
    assert table_no_wall(res) == table_no_wall(base)


def test_resume_from_complete_journal(clean, tmp_path):
    jp = str(tmp_path / "c.jsonl")
    run(journal=jp)
    res = run(resume=jp)
    assert res.resumed_cells == GRID.size and res.complete
    assert cell_reports(res) == cell_reports(clean)


def test_flaky_cell_retried_to_success(clean, monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "flaky@1:2")
    res = run()
    assert cell_reports(res) == cell_reports(clean)
    monkeypatch.setenv("REPRO_CHAOS", "flaky@1:3")
    with pytest.raises(T.CampaignError) as ei:
        run()
    assert ei.value.failed.kind == "transient"
    assert ei.value.failed.attempts == 3


def test_quarantine_accounting(clean, monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "raise@1")
    res = run(quarantine=True)
    assert len(res.cells) == GRID.size - 1
    assert [f.kind for f in res.failed_cells] == ["error"]
    fc = res.failed_cells[0]
    assert (fc.strategy, fc.scheduler, fc.load, fc.seed) in set(GRID.cells())
    assert res.missing_cells() == [fc.key()] and not res.complete
    want = {(c.strategy, c.scheduler, c.load, c.seed): c.report
            for c in clean.cells}
    for c in res.cells:
        assert c.report == want[(c.strategy, c.scheduler, c.load, c.seed)]
    j = res.to_json()
    assert j["failed_cells"][0]["kind"] == "error"
    assert j["missing_cells"] == [list(fc.key())]
    assert j["resumed_cells"] == 0
    row = next(r for r in res.aggregate()
               if (r["strategy"], r["scheduler"]) == (fc.strategy,
                                                      fc.scheduler))
    assert row["seeds"] == 1


def test_journal_resume_arg_validation(tmp_path):
    with pytest.raises(ValueError, match="not two different paths"):
        run(journal=str(tmp_path / "a"), resume=str(tmp_path / "b"))
    with pytest.raises(ValueError, match="does not exist"):
        run(resume=str(tmp_path / "missing.jsonl"))
    jp = str(tmp_path / "j.jsonl")
    run(journal=jp)
    with pytest.raises(T.JournalMismatch, match="traces"):
        T.run_campaign(T.CLUSTER512, GRID,
                       workload=dataclasses.replace(WL, num_jobs=25),
                       config=T.SimConfig(**FAST), resume=jp, device="cpu")


def test_campaign_result_save_atomic(tmp_path, clean):
    out = tmp_path / "res.json"
    clean.save(str(out))
    data = json.loads(out.read_text())
    assert data["resumed_cells"] == 0 and data["missing_cells"] == []
    assert not (tmp_path / "res.json.tmp").exists()
    clean.write_csv(str(tmp_path / "res.csv"))
    assert (tmp_path / "res.csv").read_text().startswith("strategy,")


def test_serial_cells_run_in_order_on_one_runner_thread(monkeypatch):
    """Serial mode: every attempt on one thread the runner owns (not the
    caller's), one at a time, in grid order."""
    import threading

    from repro_torch.core import campaign as TCmp
    seen = []
    real = TCmp._run_cell

    def spy(spec, trace, config, cell_index=-1, attempt=0, device="cuda"):
        seen.append((cell_index, attempt, threading.current_thread().name,
                     threading.active_count()))
        return real(spec, trace, config, cell_index, attempt, device)

    monkeypatch.setattr(TCmp, "_run_cell", spy)
    monkeypatch.setenv("REPRO_CHAOS", "flaky@2:1")
    run()
    assert [(i, a) for i, a, _, _ in seen] == [(0, 0), (1, 0), (2, 0),
                                               (2, 1), (3, 0)]
    names = {name for _, _, name, _ in seen}
    assert len(names) == 1 and names != {threading.main_thread().name}


def test_keyboard_interrupt_in_a_serial_cell_propagates(monkeypatch):
    from repro_torch.core import campaign as TCmp

    def interrupted(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr(TCmp, "_run_cell", interrupted)
    with pytest.raises(KeyboardInterrupt):
        run()


# ---------------------------------------------------------------------------
# pool campaigns: worker death, isolation, timeouts (slow: real processes)
# ---------------------------------------------------------------------------

def test_shutdown_pool_kills_hung_workers():
    """The twin of the reference's regression test, made so that it cannot
    flake: the pool's own manager thread also reaps the killed workers, and
    a worker it has reaped but not yet marked reads as alive for a moment,
    so death is read from each worker's sentinel first and ``is_alive`` is
    held only after the joins."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing.connection import wait as wait_ready

    pool = ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    pool.submit(time.sleep, 300)
    pool.submit(time.sleep, 300)
    deadline = time.monotonic() + 60.0
    while len(pool._processes or {}) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    procs = list(pool._processes.values())
    assert len(procs) == 2
    TR._shutdown_pool(pool, kill=True)
    pending = {p.sentinel for p in procs}
    while pending and time.monotonic() < deadline:
        pending -= set(wait_ready(list(pending), timeout=1.0))
    assert not pending                         # every worker has exited
    for p in procs:
        p.join(timeout=10.0)
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        time.sleep(0.01)                       # the manager thread's reap
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode is not None for p in procs)


def test_pool_workers_are_spawned(monkeypatch):
    made = []
    real = TR._spawn_pool

    def spy(workers):
        pool = real(workers)
        made.append(pool._mp_context.get_start_method())
        return pool

    monkeypatch.setattr(TR, "_spawn_pool", spy)
    run(cfg=dict(workers=2))
    assert made == ["spawn"]


class _BreaksAtSubmit(TR._SpawnPool):
    """The runner's spawn pool, broken just before its ``at``-th submission
    (its workers are killed, or before the first a worker is made to exit)
    and then submitting once the pool has marked itself broken: the moment
    a worker dies between ``wait`` and the next ``submit``."""

    def __init__(self, workers, at):
        super().__init__(workers)
        self.n, self.at = 0, at

    def submit(self, fn, /, *args, **kwargs):
        self.n += 1
        if self.n == self.at:
            if not self._processes:
                super().submit(os._exit, 1)
            for p in list(self._processes.values()):
                p.kill()
            deadline = time.monotonic() + 60.0
            while not self._broken and time.monotonic() < deadline:
                time.sleep(0.01)
            assert self._broken
        return super().submit(fn, *args, **kwargs)


@pytest.mark.parametrize("at", [1, 3])
def test_pool_broken_at_submit_recovers(clean, monkeypatch, at):
    """A pool that breaks before a submission (at 1: its idle worker died;
    at 3: cells are in flight) has its refused cell requeued and the
    crash collected, and the campaign still ends bit-identical to a clean
    run (the reference's runner lets that ``BrokenProcessPool`` out)."""
    made = []
    real = TR._spawn_pool

    def first_breaks(workers):
        pool = real(workers) if made else _BreaksAtSubmit(workers, at)
        made.append(pool)
        return pool

    monkeypatch.setattr(TR, "_spawn_pool", first_breaks)
    res = run(cfg=dict(workers=2))
    assert made[0].n >= at and len(made) >= 2
    assert cell_reports(res) == cell_reports(clean)
    assert res.complete and not res.failed_cells


@pytest.mark.slow
@pytest.mark.parametrize("store", ["full", "stream"])
def test_worker_crash_resume_bit_identical_pool(tmp_path, monkeypatch,
                                                store):
    base = run(cfg=dict(store=store))
    jp = str(tmp_path / "p.jsonl")
    monkeypatch.setenv("REPRO_CHAOS", "crash@2")
    with pytest.raises(T.CampaignError) as ei:
        run(journal=jp, cfg=dict(store=store, workers=4))
    assert ei.value.failed.kind == "crash"
    monkeypatch.delenv("REPRO_CHAOS")
    res = run(resume=jp, cfg=dict(store=store, workers=4))
    assert cell_reports(res) == cell_reports(base)
    assert table_no_wall(res) == table_no_wall(base)


@pytest.mark.slow
def test_worker_crash_once_recovers_via_isolation(clean, monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "crash@2:1")
    res = run(cfg=dict(workers=4))
    assert cell_reports(res) == cell_reports(clean)
    assert res.complete and not res.failed_cells


@pytest.mark.slow
def test_hung_cell_timeout_quarantined(clean, monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "hang@0")
    monkeypatch.setenv("REPRO_CHAOS_HANG", "60")
    res = run(cfg=dict(workers=2, cell_timeout=3.0, max_retries=0,
                       quarantine=True))
    assert [f.kind for f in res.failed_cells] == ["timeout"]
    assert "cell_timeout" in res.failed_cells[0].error
    want = {(c.strategy, c.scheduler, c.load, c.seed): c.report
            for c in clean.cells}
    assert len(res.cells) == GRID.size - 1
    for c in res.cells:
        assert c.report == want[(c.strategy, c.scheduler, c.load, c.seed)]


@pytest.mark.slow
def test_hung_cell_timeout_retry_recovers(clean, monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "hang@3:1")
    monkeypatch.setenv("REPRO_CHAOS_HANG", "60")
    res = run(cfg=dict(cell_timeout=3.0))
    assert cell_reports(res) == cell_reports(clean)
    assert res.complete and not res.failed_cells


@pytest.mark.parametrize("chaos", ["", "hang@0"], ids=["clean", "hang@0"])
def test_slow_worker_startup_is_not_cell_time(clean, monkeypatch, chaos):
    """Spawned workers that take longer to start than ``cell_timeout``
    (as under a loaded test run, or on a card's host): the deadline runs
    from the moment a worker begins the cell, so no innocent cell times
    out, and a hung one is still killed after its own ``cell_timeout``."""
    monkeypatch.setenv("REPRO_CHAOS_STARTUP", "5")
    monkeypatch.setenv("REPRO_CHAOS", chaos)
    monkeypatch.setenv("REPRO_CHAOS_HANG", "60")
    res = run(cfg=dict(workers=2, cell_timeout=3.0, max_retries=0,
                       quarantine=True))
    want = {(c.strategy, c.scheduler, c.load, c.seed): c.report
            for c in clean.cells}
    if not chaos:
        assert cell_reports(res) == cell_reports(clean)
        assert res.complete and not res.failed_cells
        return
    first = clean.cells[0]             # grid order: cell 0 hangs
    assert [(f.kind, f.key()) for f in res.failed_cells] == [
        ("timeout", (first.strategy, first.scheduler, first.load,
                     first.seed))]
    assert len(res.cells) == GRID.size - 1
    for c in res.cells:
        assert c.report == want[(c.strategy, c.scheduler, c.load, c.seed)]


def _never_starts(monkeypatch, first_only: bool) -> list:
    """Pool generations whose workers never begin a cell (their start-up
    sleeps far past the start-up limit, through ``REPRO_CHAOS_STARTUP``):
    the first generation alone, or every one.  The list of the pools
    made."""
    made = []
    real = TR._spawn_pool
    default = TR.STARTUP_LIMIT

    def spawn(workers):
        if first_only and made:
            monkeypatch.delenv("REPRO_CHAOS_STARTUP")
            monkeypatch.setattr(TR, "STARTUP_LIMIT", default)
        made.append(real(workers))
        return made[-1]

    monkeypatch.setenv("REPRO_CHAOS_STARTUP", "600")
    monkeypatch.setattr(TR, "_spawn_pool", spawn)
    return made


@pytest.mark.parametrize("cell_timeout", [3.0, 0.0],
                         ids=["cell_timeout", "no_cell_timeout"])
def test_workers_that_never_start_are_rebuilt_without_penalty(
        clean, monkeypatch, cell_timeout):
    """A generation whose workers never begin a cell is killed after the
    start-up limit and rebuilt, with or without a ``cell_timeout``; its
    cells go back without an attempt penalty, so a campaign with
    ``max_retries=0`` still completes."""
    made = _never_starts(monkeypatch, first_only=True)
    monkeypatch.setattr(TR, "STARTUP_LIMIT", 2.0)
    res = run(cfg=dict(workers=2, cell_timeout=cell_timeout, max_retries=0))
    assert len(made) == 2
    assert cell_reports(res) == cell_reports(clean)
    assert res.complete and not res.failed_cells


def test_workers_that_never_start_stop_the_run(monkeypatch):
    """Generations that never start end the run after ``MAX_STALLS`` of
    them instead of rebuilding for ever."""
    made = _never_starts(monkeypatch, first_only=False)
    monkeypatch.setattr(TR, "STARTUP_LIMIT", 1.0)
    with pytest.raises(RuntimeError, match="STARTUP_LIMIT"):
        run(cfg=dict(workers=2, cell_timeout=3.0))
    assert len(made) == TR.MAX_STALLS


# ---------------------------------------------------------------------------
# CLI validation: exit codes and messages equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--cell-timeout", "0"],
    ["--cell-timeout", "-2"],
    ["--max-retries", "-1"],
    ["--resume", "/nonexistent/journal.jsonl"],
    ["--journal", "/tmp/a.jsonl", "--resume", "/tmp/b.jsonl"],
])
def test_sweep_campaign_cli_validation(argv, capsys):
    from repro.launch.sweep import campaign_main as ref_main
    from repro_torch.launch.sweep import campaign_main
    with pytest.raises(SystemExit) as ei:
        campaign_main(argv + ["--device", "cpu"])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert argv[0].lstrip("-").split()[0] in err.replace("_", "-") \
        or "journal" in err
    with pytest.raises(SystemExit) as ref:
        ref_main(argv)
    assert ref.value.code == 2
    # the usage above the message lists the port's extra --device flag
    assert capsys.readouterr().err.splitlines()[-1] == err.splitlines()[-1]


def test_sweep_campaign_cli_journal_exists(tmp_path, capsys):
    jp = tmp_path / "exists.jsonl"
    jp.write_text("{}\n")
    from repro_torch.launch.sweep import campaign_main
    with pytest.raises(SystemExit) as ei:
        campaign_main(["--journal", str(jp), "--device", "cpu"])
    assert ei.value.code == 2
    assert "--resume" in capsys.readouterr().err
