"""Port vs reference: trace ingestion (``repro_torch.core.traces`` and the
CSV half of ``repro_torch.core.workloads``).

The same files, written from seeded numpy / ``generate_trace``, go through
both packages: jobs must agree field by field, and every refusal must carry
the reference's exception type and message.  The twins of
``tests/test_traces.py`` and of the CSV tests of ``tests/test_workloads.py``
hold the port to the same contracts.  The port parses without ``try``
(validate, then convert), so the tables below hold its checks to exactly
what ``float()`` / ``int()`` accept.
"""

import csv
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import traces as RT  # noqa: E402
from repro.core import workloads as RW  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import traces as TT  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.core.jobs import BATCHES, PROFILES, Job  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REF_FIXTURE = ROOT / "src" / "repro" / "data" / "alibaba_sample.csv"
ALIBABA_FIXTURE = ROOT / "src" / "repro_torch" / "data" / "alibaba_sample.csv"
HEADER = ("job_id,model,num_gpus,batch_size,arrival,num_iters,"
          "allreduce_algo,deadline\n")


def _fields(j):
    return (j.job_id, j.model, j.num_gpus, j.batch_size, j.arrival,
            j.num_iters, j.allreduce_algo, j.deadline)


def _same_jobs(a, b):
    assert [dataclasses.asdict(j) for j in a] == \
        [dataclasses.asdict(j) for j in b]


def _outcome(fn, *args, **kwargs):
    """The value, or the exception's type name and message."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the comparison is the point
        return (type(e).__name__, str(e))


@pytest.fixture()
def native_csv(tmp_path):
    jobs = T.generate_trace(T.WorkloadSpec(num_jobs=150, seed=11,
                                           deadline_slack=(2.0, 3.0)))
    path = tmp_path / "trace.csv"
    T.save_trace_csv(jobs, str(path))
    return jobs, str(path)


# ---------------------------------------------------------------------------
# the config divergence (repaired): named formats are accepted as in the
# reference, unknown ones refused with its message
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["csv", "alibaba", "generic", "auto"])
def test_simconfig_trace_format_matches_reference(fmt):
    assert R.SimConfig(trace_format=fmt).trace_format == fmt
    assert T.SimConfig(trace_format=fmt).trace_format == fmt


@pytest.mark.parametrize("fmt", ["philly", "CSV", "", "csv "])
def test_simconfig_refuses_what_the_reference_refuses(fmt):
    assert _outcome(T.SimConfig, trace_format=fmt) == \
        _outcome(R.SimConfig, trace_format=fmt)
    assert _outcome(T.SimConfig, trace_format=fmt)[0] == "ValueError"


# ---------------------------------------------------------------------------
# workloads: the CSV half (twins of tests/test_workloads.py:78-161)
# ---------------------------------------------------------------------------

def test_csv_round_trip(tmp_path):
    jobs = T.generate_trace(T.WorkloadSpec(num_jobs=120, seed=5,
                                           deadline_slack=(2.0, 3.0)))
    path = tmp_path / "trace.csv"
    T.save_trace_csv(jobs, str(path))
    back = T.load_trace_csv(str(path))
    assert [_fields(x) for x in jobs] == [_fields(x) for x in back]
    # the reference reads the port's file into the same jobs, and writes
    # the same bytes from its own copy of the trace
    _same_jobs(back, R.load_trace_csv(str(path)))
    ref_path = tmp_path / "ref.csv"
    R.save_trace_csv(R.generate_trace(R.WorkloadSpec(
        num_jobs=120, seed=5, deadline_slack=(2.0, 3.0))), str(ref_path))
    assert ref_path.read_bytes() == path.read_bytes()


def test_csv_validation(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text(HEADER + "0,not_a_model,8,32,0.0,100,ring,\n")
    with pytest.raises(ValueError, match="unknown model"):
        T.load_trace_csv(str(path))
    path.write_text(HEADER + "0,vgg16,8,32,0.0,100,warp,\n")
    with pytest.raises(ValueError, match="allreduce"):
        T.load_trace_csv(str(path))
    (tmp_path / "cols.csv").write_text("job_id,model\n0,vgg16\n")
    with pytest.raises(ValueError, match="missing columns"):
        T.load_trace_csv(str(tmp_path / "cols.csv"))


def test_csv_rejects_non_finite_and_negative_times(tmp_path):
    path = tmp_path / "bad.csv"
    for arrival in ("nan", "inf", "-inf", "-1.0"):
        path.write_text(HEADER + f"0,vgg16,8,32,{arrival},100,ring,\n")
        with pytest.raises(ValueError, match=r"trace .*bad\.csv:2: "):
            T.load_trace_csv(str(path))
    path.write_text(HEADER + "0,vgg16,8,32,0.0,100,ring,nan\n")
    with pytest.raises(ValueError, match="deadline"):
        T.load_trace_csv(str(path))
    path.write_text(HEADER + "0,vgg16,8,32,abc,100,ring,\n")
    with pytest.raises(ValueError, match="not a number"):
        T.load_trace_csv(str(path))


def test_csv_rejects_non_positive_batch_size(tmp_path):
    path = tmp_path / "bad.csv"
    for batch in ("0", "-4"):
        path.write_text(HEADER + f"0,vgg16,8,{batch},0.0,100,ring,\n")
        with pytest.raises(ValueError, match="batch_size"):
            T.load_trace_csv(str(path))


def test_equal_arrival_tie_break_is_deterministic(tmp_path):
    jobs = T.generate_trace(T.WorkloadSpec(num_jobs=40, seed=2))
    flat = [dataclasses.replace(j, arrival=60.0) for j in jobs]
    path = tmp_path / "flat.csv"
    T.save_trace_csv(list(reversed(flat)), str(path))
    back = T.load_trace_csv(str(path))
    assert [j.job_id for j in back] == sorted(j.job_id for j in back)
    _same_jobs(back, R.load_trace_csv(str(path)))


def test_zero_span_trace_stats_finite():
    jobs = T.generate_trace(T.WorkloadSpec(num_jobs=10, seed=0))
    flat = [dataclasses.replace(j, arrival=5.0) for j in jobs]
    stats = T.trace_stats(flat)
    assert stats["arrival_rate"] == 0.0
    assert stats["mean_interarrival"] == 0.0
    assert T.trace_stats(jobs[:1])["arrival_rate"] == 0.0


def test_load_trace_sorts_by_arrival(tmp_path):
    jobs = T.generate_trace(T.WorkloadSpec(num_jobs=30, seed=1))
    path = tmp_path / "shuffled.csv"
    T.save_trace_csv(list(reversed(jobs)), str(path))
    back = T.load_trace_csv(str(path))
    assert [j.arrival for j in back] == sorted(j.arrival for j in back)


#: rows the CSV contract accepts or refuses: each column bad in turn
BAD_ROWS = [
    "0,vgg16,8,32,0.0,100,ring,",             # fine
    "x,vgg16,8,32,0.0,100,ring,",             # int() of the id
    "0,vgg16,8.5,32,0.0,100,ring,",
    "0,vgg16,0,32,0.0,100,ring,",
    "0,vgg16,8,32,0.0,0,ring,",
    "0,vgg16,8,0,0.0,100,ring,",
    "0,vgg16,8,32,,100,ring,",
    "0,vgg16,8,32, 1e3 ,100,ring,",
    "0,vgg16,8,32,1_0,100,ring,",
    "0,vgg16,8,32,0x10,100,ring,",
    "0,vgg16,8,32,0.0,100,ring,-0.0",
    "0,vgg16,8,32,0.0,100,ring,Infinity",
    "0,vgg16,8,32,0.0,100,,",
    "0,vgg16,8,32,0.0,100",                   # short row
]


@pytest.mark.parametrize("row", BAD_ROWS)
def test_load_trace_csv_accepts_and_refuses_as_the_reference(tmp_path, row):
    path = tmp_path / "rows.csv"
    path.write_text(HEADER + "1,bert,4,16,5.0,10,hd,9.0\n" + row + "\n")
    got, want = (_outcome(pkg.load_trace_csv, str(path)) for pkg in (T, R))
    assert got[0] == want[0]
    if got[0] == "ok":
        _same_jobs(got[1], want[1])
    else:
        assert got[1] == want[1]


#: raw time cells: what float() accepts (and then the range checks refuse
#: non-finite and negative values), and what it refuses
TIME_STRINGS = [
    "0", "1e3", " 7 ", "\t2.5\n", "1_0", "1_000.000_1", "+3", "-0.0", "-1",
    ".5", "5.", "1E-3", "inf", "-inf", "Infinity", "nan", "NaN", "+nan",
    "١٢", "", "   ", "x", "1__0", "_1", "1_", "1e", "e5", ".",
    "0x10", "1,5", "1.5.2", "in f", "1e3.0", "--1", "1e_3", "٣.٥",
]


@pytest.mark.parametrize("raw", TIME_STRINGS, ids=repr)
@pytest.mark.parametrize("allow_none", [False, True])
def test_parse_trace_time_matches_reference(raw, allow_none):
    args = (raw, "arrival", "t.csv", 7)
    got = _outcome(TW.parse_trace_time, *args, allow_none=allow_none)
    want = _outcome(RW.parse_trace_time, *args, allow_none=allow_none)
    assert got == want


def test_float_literal_check_is_float_on_random_strings():
    """``is_float_literal`` stands for ``float()``'s own parse: held on 20k
    seeded random strings over the characters of the float grammar."""
    rng = np.random.default_rng(0)
    alphabet = list("0123456789_.eE+-infatyINFATY \t") + ["٣", "x"]
    for _ in range(20000):
        n = int(rng.integers(0, 8))
        s = "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet),
                                                           n))
        accepted = _outcome(float, s)[0] == "ok"
        assert TW.is_float_literal(s) == accepted, repr(s)


# ---------------------------------------------------------------------------
# traces: twins of tests/test_traces.py
# ---------------------------------------------------------------------------

def test_native_round_trip_bit_identical(native_csv):
    jobs, path = native_csv
    back = T.TraceSource(path, format="csv").load()
    assert [_fields(j) for j in back] == [_fields(j) for j in jobs]
    assert back == T.load_trace_csv(path)


def test_generic_adapter_round_trips_renamed_columns(native_csv, tmp_path):
    jobs, path = native_csv
    renames = {"job_id": "jobid", "num_gpus": "gpu_num",
               "arrival": "submit_time", "num_iters": "iterations",
               "batch_size": "batchsize"}
    out = tmp_path / "renamed.csv"
    with open(path) as f:
        rows = list(csv.DictReader(f))
    cols = [renames.get(c, c) for c in rows[0]]
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for r in rows:
            w.writerow({renames.get(k, k): v for k, v in r.items()})
    src = T.TraceSource(str(out), format="auto")
    assert src.resolve_format() == "generic"
    back = src.load()
    assert [_fields(j) for j in back] == [_fields(j) for j in jobs]


def test_generic_adapter_derives_iters_from_duration(tmp_path):
    path = tmp_path / "g.csv"
    path.write_text("job_name,gpus,submit_time,run_time\n"
                    "jobA,4,100,3600\njobB,2,200,0\njobC,1,300,1800\n")
    src = T.TraceSource(str(path), format="generic")
    jobs = src.load()
    assert [j.job_id for j in jobs] == [0, 2]
    assert src.last_adapter.skipped == 1
    for j in jobs:
        assert j.model in PROFILES and j.num_iters >= 1
        assert j.batch_size == BATCHES[j.model][0]
    _same_jobs(jobs, R.TraceSource(str(path), format="generic").load())


def test_detect_format():
    assert T.detect_format(("job_id", "model", "num_gpus", "batch_size",
                            "arrival", "num_iters", "allreduce_algo",
                            "deadline")) == "csv"
    assert T.detect_format(("job_name", "task_name", "inst_num", "plan_gpu",
                            "start_time", "end_time", "status")) == "alibaba"
    assert T.detect_format(("jobid", "gpu_num", "submit_time",
                            "duration")) == "generic"
    with pytest.raises(T.TraceFormatError, match="no trace adapter"):
        T.detect_format(("foo", "bar"))
    assert tuple(T.ADAPTERS) == ("csv", "alibaba", "generic")
    assert T.TRACE_FORMATS == ("csv", "alibaba", "generic", "auto")
    assert T.TRACE_FORMATS == R.TRACE_FORMATS


def test_trace_source_validates_inputs(tmp_path):
    with pytest.raises(ValueError, match="unknown trace format"):
        T.TraceSource("x.csv", format="philly")
    with pytest.raises(ValueError, match="reorder_window"):
        T.TraceSource("x.csv", reorder_window=0)
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    with pytest.raises(T.TraceFormatError, match="no header"):
        T.TraceSource(str(empty)).load()


def test_simconfig_trace_format_validated():
    assert T.SimConfig(trace_format="alibaba").trace_format == "alibaba"
    with pytest.raises(ValueError, match="unknown trace format"):
        T.SimConfig(trace_format="philly")


def test_alibaba_fixture_normalizes():
    src = T.TraceSource(str(ALIBABA_FIXTURE), format="auto")
    assert src.resolve_format() == "alibaba"
    jobs = src.load()
    assert len(jobs) == 25
    assert src.last_adapter.skipped == 5
    for j in jobs:
        assert j.model in PROFILES
        assert j.num_gpus >= 1 and j.num_iters >= 1
        assert j.batch_size >= 1 and j.arrival >= 0
    arrivals = [(j.arrival, j.job_id) for j in jobs]
    assert arrivals == sorted(arrivals)
    assert sorted(j.job_id for j in jobs) == list(range(25))


def test_alibaba_fixture_is_the_references():
    """The port's copy is byte-identical, holds 51 task rows, and
    normalises to the reference's 25 jobs under ``auto`` and ``alibaba``."""
    assert ALIBABA_FIXTURE.read_bytes() == REF_FIXTURE.read_bytes()
    with open(ALIBABA_FIXTURE, newline="") as f:
        assert len(list(csv.DictReader(f))) == 51
    ref = R.TraceSource(str(REF_FIXTURE), format="alibaba").load()
    for fmt in ("auto", "alibaba"):
        jobs = T.TraceSource(str(ALIBABA_FIXTURE), format=fmt).load()
        assert len(jobs) == 25
        _same_jobs(jobs, ref)


def test_alibaba_gpu_taxonomy(tmp_path):
    path = tmp_path / "ali.csv"
    path.write_text(
        "job_name,task_name,inst_num,plan_gpu,start_time,end_time,status\n"
        "j1,worker,4,50,0,1000,Terminated\n"
        "j1,ps,8,100,0,1000,Terminated\n"
        "j2,chief,1,100,10,2000,Terminated\n"
        "j2,evaluator,2,100,10,2000,Terminated\n"
        "j3,worker,1,100,20,3000,Terminated\n"
        "j3,evaluator,1,0,20,3000,Terminated\n")
    jobs = T.TraceSource(str(path), format="alibaba").load()
    assert [(j.job_id, j.num_gpus) for j in jobs] == [(0, 2), (1, 3), (2, 1)]


def test_alibaba_skips_and_group_contract(tmp_path):
    header = ("job_name,task_name,inst_num,plan_gpu,start_time,end_time,"
              "status\n")
    path = tmp_path / "ali.csv"
    path.write_text(header +
                    "a,worker,1,100,0,100,Failed\n"
                    "b,ps,2,0,5,100,Terminated\n"
                    "c,worker,1,100,10,10,Terminated\n"
                    "d,worker,1,100,20,120,Terminated\n")
    src = T.TraceSource(str(path), format="alibaba")
    jobs = src.load()
    assert len(jobs) == 1 and src.last_adapter.skipped == 3
    path.write_text(header +
                    "a,worker,1,100,0,100,Terminated\n"
                    "b,worker,1,100,5,100,Terminated\n"
                    "a,ps,1,0,0,100,Terminated\n")
    with pytest.raises(T.TraceFormatError, match="reappears"):
        T.TraceSource(str(path), format="alibaba").load()


#: (inst_num, plan_gpu) cells of one alibaba worker row
ALIBABA_CELLS = [("4", "50"), ("", ""), (" ", " "), ("2.9", "100"),
                 ("nan", "100"), ("inf", "100"), ("x", "100"), ("1", "x"),
                 ("1", "nan"), ("1", "inf"), ("-2", "100"), ("1", "-50"),
                 ("1e1", "1_0"), ("x", "inf")]


@pytest.mark.parametrize("inst,plan", ALIBABA_CELLS)
def test_alibaba_cells_match_reference(tmp_path, inst, plan):
    path = tmp_path / "ali.csv"
    path.write_text("job_name,task_name,inst_num,plan_gpu,start_time,"
                    f"end_time\nj1,worker,{inst},{plan},0,1000\n"
                    "j2,worker,1,100,5,900\n")
    got, want = (_outcome(pkg.TraceSource(str(path), format="alibaba").load)
                 for pkg in (T, R))
    assert got[0] == want[0]
    if got[0] == "ok":
        _same_jobs(got[1], want[1])
    else:
        assert got[1] == want[1]


#: num_gpus cells of one generic row
GENERIC_GPUS = ["4", "2.5", "0", "-3", "nan", "inf", "x", "", " 8 ", "1_6"]


@pytest.mark.parametrize("gpus", GENERIC_GPUS)
def test_generic_num_gpus_matches_reference(tmp_path, gpus):
    path = tmp_path / "g.csv"
    path.write_text("job_name,gpus,submit_time,run_time\n"
                    f"jobA,{gpus},100,3600\njobB,2,200,50\n")
    got, want = (_outcome(pkg.TraceSource(str(path), format="generic").load)
                 for pkg in (T, R))
    assert got[0] == want[0]
    if got[0] == "ok":
        _same_jobs(got[1], want[1])
    else:
        assert got[1] == want[1]


def test_streaming_equals_eager(native_csv):
    jobs, path = native_csv
    src = T.TraceSource(path, format="csv")
    assert list(src.iter_jobs()) == src.load()
    ali = T.TraceSource(str(ALIBABA_FIXTURE), format="alibaba")
    assert list(ali.iter_jobs()) == ali.load()


def test_streaming_reorder_buffer(native_csv, tmp_path):
    jobs, _ = native_csv
    path = tmp_path / "shuffled.csv"
    T.save_trace_csv(list(reversed(jobs)), str(path))
    ordered = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    assert list(T.TraceSource(str(path), format="csv",
                              reorder_window=len(jobs)).iter_jobs()) == ordered
    with pytest.raises(T.TraceFormatError, match="out of order"):
        list(T.TraceSource(str(path), format="csv",
                           reorder_window=4).iter_jobs())


def test_abandoned_stream_closes_its_file(native_csv):
    """The reference closes the file in ``finally``; the port's ``with``
    must close it too when the generator is closed unfinished."""
    _, path = native_csv
    src = T.TraceSource(path, format="csv")
    it = src.iter_jobs()
    next(it)
    f = it.gi_frame.f_locals["f"]
    assert not f.closed
    it.close()
    assert f.closed


def test_rebase_and_max_gpus(native_csv, tmp_path):
    jobs, _ = native_csv
    shifted = [dataclasses.replace(j, arrival=j.arrival + 1e6,
                                   deadline=(None if j.deadline is None
                                             else j.deadline + 1e6))
               for j in jobs]
    path = tmp_path / "shifted.csv"
    T.save_trace_csv(shifted, str(path))
    src = T.TraceSource(str(path), format="csv", rebase=True, max_gpus=8)
    back = list(src.iter_jobs())
    assert back[0].arrival == 0.0
    assert [j.arrival for j in back] == pytest.approx(
        [j.arrival - jobs[0].arrival for j in jobs])
    assert max(j.num_gpus for j in back) <= 8
    assert back == src.load()
    _same_jobs(back, R.TraceSource(str(path), format="csv", rebase=True,
                                   max_gpus=8).load())


def test_iter_windows_overlap_and_coverage(native_csv):
    jobs, _ = native_csv
    ws = list(T.iter_windows(jobs, window_jobs=60, stride_jobs=30))
    assert [(w.index, w.start, len(w.jobs)) for w in ws] == [
        (0, 0, 60), (1, 30, 60), (2, 60, 60), (3, 90, 60), (4, 120, 30)]
    for w in ws:
        chunk = jobs[w.start:w.start + 60]
        assert w.t0 == chunk[0].arrival
        assert [j.job_id for j in w.jobs] == [j.job_id for j in chunk]
        assert w.jobs[0].arrival == 0.0
        assert [j.arrival for j in w.jobs] == pytest.approx(
            [j.arrival - w.t0 for j in chunk])


def test_iter_windows_max_windows_stops_consuming(native_csv):
    jobs, _ = native_csv
    pulled = []

    def feed():
        for j in jobs:
            pulled.append(j.job_id)
            yield j

    ws = list(T.iter_windows(feed(), window_jobs=20, stride_jobs=20,
                             max_windows=2))
    assert [(w.index, len(w.jobs)) for w in ws] == [(0, 20), (1, 20)]
    assert len(pulled) == 40


def test_iter_windows_edge_shapes(native_csv):
    jobs, _ = native_csv
    ws = list(T.iter_windows(jobs[:100], window_jobs=10, stride_jobs=50))
    assert [(w.index, w.start) for w in ws] == [(0, 0), (1, 50)]
    ws = list(T.iter_windows(jobs[:7], window_jobs=10))
    assert [(w.index, len(w.jobs)) for w in ws] == [(0, 7)]
    assert list(T.iter_windows([], window_jobs=10)) == []
    with pytest.raises(ValueError, match="window_jobs"):
        list(T.iter_windows(jobs, window_jobs=0))


@pytest.mark.parametrize("window,stride,max_windows", [
    (60, 30, None), (20, 20, 2), (10, 50, None), (7, 3, 4)])
def test_iter_windows_match_reference(native_csv, window, stride,
                                      max_windows):
    _, path = native_csv
    got = list(T.iter_windows(T.TraceSource(path).iter_jobs(), window,
                              stride, max_windows))
    want = list(R.iter_windows(R.TraceSource(path).iter_jobs(), window,
                               stride, max_windows))
    assert [(w.index, w.start, w.t0) for w in got] == \
        [(w.index, w.start, w.t0) for w in want]
    for a, b in zip(got, want):
        _same_jobs(a.jobs, b.jobs)


def test_run_windowed_campaign(native_csv):
    jobs, path = native_csv
    grid = T.CampaignGrid(strategies=("ecmp", "sr"), loads=(120.0,))
    res = T.run_windowed_campaign(
        T.TESTBED32, grid, T.TraceSource(path, format="csv", max_gpus=16),
        window_jobs=50, stride_jobs=50, device="cpu")
    assert res.grid.seeds == (0, 1, 2)
    assert len(res.cells) == 6 and res.missing_cells() == []
    rows = res.aggregate()
    assert {r["strategy"] for r in rows} == {"ecmp", "sr"}
    assert all(r["seeds"] == 3 for r in rows)
    assert all(r["n_finished"] == 150 for r in rows)


def test_run_windowed_campaign_validates_grid(native_csv):
    _, path = native_csv
    bad = T.CampaignGrid(strategies=("ecmp",), seeds=(0, 1))
    with pytest.raises(ValueError, match="seeds axis"):
        T.run_windowed_campaign(T.TESTBED32, bad, path, window_jobs=50,
                                device="cpu")
    with pytest.raises(ValueError, match="max_windows"):
        T.run_windowed_campaign(
            T.TESTBED32, T.CampaignGrid(strategies=("ecmp",)),
            T.TraceSource(path, format="csv", max_gpus=16),
            window_jobs=50, max_windows=0, device="cpu")


def test_run_windowed_campaign_empty_trace(tmp_path):
    path = tmp_path / "empty.csv"
    path.write_text(HEADER)
    with pytest.raises(ValueError, match="no windows"):
        T.run_windowed_campaign(T.TESTBED32,
                                T.CampaignGrid(strategies=("ecmp",)),
                                str(path), window_jobs=50, device="cpu")


def test_interner_is_first_appearance_dense():
    it = T.JobIdInterner()
    assert [it.intern(x) for x in ("b", "a", "b", "c")] == [0, 1, 0, 2]
    assert it.mapping() == {"b": 0, "a": 1, "c": 2}
    assert "a" in it and "z" not in it


def test_stable_model_assignment():
    assert T.stable_model_for("job-123") == T.stable_model_for("job-123")
    assert T.stable_model_for("job-123") in PROFILES
    pool = {T.stable_model_for(f"job-{i}") for i in range(200)}
    assert len(pool) > 1
    # crc32 in both packages: the same raw id maps to the same model
    for raw in [f"job-{i}" for i in range(500)] + [7, "é", ""]:
        assert T.stable_model_for(raw) == R.stable_model_for(raw)


def test_iters_for_duration_inverts_iter_time():
    for model in ("vgg16", "bert"):
        job = Job(0, model, 4, BATCHES[model][0], 0.0, 1)
        per_iter = job.iter_time(1.0)
        iters = T.iters_for_duration(model, 4, BATCHES[model][0],
                                     1000 * per_iter)
        assert iters == pytest.approx(1000, abs=1)
    assert T.iters_for_duration("vgg16", 1, 32, 1e-9) == 1
    rng = np.random.default_rng(3)
    for _ in range(200):
        model = sorted(PROFILES)[int(rng.integers(len(PROFILES)))]
        gpus, dur = int(rng.integers(1, 65)), float(rng.exponential(5e3))
        assert T.iters_for_duration(model, gpus, 32, dur) == \
            R.iters_for_duration(model, gpus, 32, dur)


def test_summary_and_fit(native_csv):
    jobs, _ = native_csv
    s = T.summarize_jobs(jobs)
    assert s.n == len(jobs)
    assert s.span == jobs[-1].arrival - jobs[0].arrival
    assert sum(p for _, p in s.size_mix) == pytest.approx(1.0)
    assert T.empirical_size_mix(jobs) == s.size_mix
    spec = T.fit_workload(jobs, seed=9)
    assert spec.num_jobs == len(jobs) and spec.seed == 9
    assert spec.mean_interarrival == pytest.approx(s.span / (s.n - 1))
    assert spec.size_mix == s.size_mix
    regen = T.generate_trace(spec)
    assert {j.num_gpus for j in regen} <= {g for g, _ in s.size_mix}
    assert T.summarize_jobs([]).n == 0
    with pytest.raises(ValueError, match="empty"):
        T.fit_workload([])
    assert dataclasses.asdict(s) == dataclasses.asdict(
        R.summarize_jobs(R.load_trace_csv(native_csv[1])))
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        R.fit_workload(R.load_trace_csv(native_csv[1]), seed=9))


# ---------------------------------------------------------------------------
# the same files through both packages, every format
# ---------------------------------------------------------------------------

def _generic_file(tmp_path, jobs):
    """A Philly-style job-level file from seeded numpy: string ids, GPU
    counts, submit times and either run times or end times."""
    rng = np.random.default_rng(7)
    path = tmp_path / "philly.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["jobname", "gpu_num", "submit_time", "runtime",
                    "end_time", "model", "deadline"])
        t = 0.0
        for i in range(len(jobs)):
            t += float(rng.exponential(90.0))
            run = float(rng.lognormal(7.0, 1.2)) if i % 7 else 0.0
            w.writerow([f"philly-{int(rng.integers(1 << 30)):x}-{i}",
                        int(rng.choice([1, 2, 4, 8, 16])), repr(t),
                        repr(run) if i % 3 else "",
                        repr(t + run),
                        "" if i % 2 else jobs[i].model,
                        "" if i % 5 else repr(t + 3 * run)])
    return str(path)


@pytest.mark.parametrize("fmt", ["csv", "generic", "alibaba"])
def test_trace_source_load_and_stream_match_reference(native_csv, tmp_path,
                                                      fmt):
    jobs, path = native_csv
    if fmt == "generic":
        path = _generic_file(tmp_path, jobs)
    if fmt == "alibaba":
        path = str(ALIBABA_FIXTURE)
    for kw in ({}, {"rebase": True, "max_gpus": 4},
               {"reorder_window": 3}):
        t_src = T.TraceSource(path, format=fmt, **kw)
        r_src = R.TraceSource(path, format=fmt, **kw)
        loaded = t_src.load()
        assert loaded
        _same_jobs(loaded, r_src.load())
        assert t_src.last_adapter.skipped == r_src.last_adapter.skipped
        assert t_src.last_adapter.interner.mapping() == \
            r_src.last_adapter.interner.mapping()
        got = _outcome(lambda: list(T.TraceSource(path, format=fmt,
                                                  **kw).iter_jobs()))
        want = _outcome(lambda: list(R.TraceSource(path, format=fmt,
                                                   **kw).iter_jobs()))
        assert got[0] == want[0]
        if got[0] == "ok":
            _same_jobs(got[1], want[1])
        else:
            assert got[1] == want[1]


def test_trace_module_surface_matches_reference():
    assert TT.TRACE_FORMATS == RT.TRACE_FORMATS
    assert TW.TRACE_FIELDS == RW.TRACE_FIELDS
    assert TT._MODEL_POOL == RT._MODEL_POOL
    assert TT.GenericCSVAdapter.ALIASES == RT.GenericCSVAdapter.ALIASES
    for name in ("WORKER_TASKS", "PS_TASKS", "EVALUATOR_TASKS"):
        assert getattr(TT.AlibabaAdapter, name) == \
            getattr(RT.AlibabaAdapter, name)
    assert [f.name for f in dataclasses.fields(T.TraceSource)] == \
        [f.name for f in dataclasses.fields(R.TraceSource)]
