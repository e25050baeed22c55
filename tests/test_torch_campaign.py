"""Port vs reference: simulation campaigns (``repro_torch.core.campaign``)
and their CLI (``repro_torch.launch.sweep campaign``), the slice as a whole.

* the port's ``campaign_main([..., "--device", "cpu"])`` against the
  reference's ``campaign_main`` on the same argv: the JSON reports are
  identical once the wall-clock keys (``sim_seconds``, ``wall_time``,
  ``journal_seconds``) are dropped, and so are the printed tables; bad input
  exits with the reference's code and message;
* journals cross packages: a journal the reference left with a quarantined
  cell is resumed by the port, and the port's by the reference, both merging
  to the clean run's report;
* twins of the campaign tests of ``tests/test_campaign.py`` on
  ``device="cpu"``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.launch import sweep as RS  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import runtime as TR  # noqa: E402
from repro_torch.launch import sweep as TS  # noqa: E402

WALL_KEYS = {"sim_seconds", "wall_time", "journal_seconds"}
BASE = ["--cluster", "512", "--strategies", "ecmp,sr,best", "--loads", "120",
        "--seeds", "0,1", "--jobs", "40", "--max-gpus", "64"]
ALIBABA = "src/repro_torch/data/alibaba_sample.csv"


def drop_wall(obj):
    if isinstance(obj, dict):
        return {k: drop_wall(v) for k, v in obj.items()
                if k not in WALL_KEYS}
    if isinstance(obj, list):
        return [drop_wall(v) for v in obj]
    return obj


def table_lines(out: str):
    """The printed aggregate table (progress lines carry wall times)."""
    return [line for line in out.splitlines()
            if not line.startswith(("[campaign]", "[windowed]"))]


def run_cli(main, argv, out_path, capsys):
    main(argv + ["--out", str(out_path)])
    printed = capsys.readouterr().out
    return drop_wall(json.loads(out_path.read_text())), table_lines(printed)


@pytest.fixture(scope="module")
def native_trace(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "jobs.csv"
    T.save_trace_csv(T.generate_trace(T.WorkloadSpec(
        num_jobs=40, seed=4, max_gpus=64, deadline_slack=(1.5, 3.0))),
        str(path))
    return str(path)


CASES = {
    "serial-v2": BASE,
    "engine-v1": BASE + ["--engine", "v1"],
    "engine-batched": BASE + ["--engine", "batched"],
    "workers-2": BASE + ["--workers", "2"],
    "stream": BASE + ["--stream"],
    "events": BASE + ["--events", "preempt=0.1"],
    "trace-native": ["--cluster", "512", "--strategies", "ecmp,sr,best",
                     "--seeds", "0", "--trace", "NATIVE"],
    "trace-alibaba-windowed": ["--cluster", "512", "--strategies",
                               "best,sr,ecmp", "--trace", ALIBABA,
                               "--trace-format", "alibaba", "--window", "10",
                               "--stride", "5"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_campaign_matches_reference(case, native_trace, tmp_path,
                                          capsys):
    argv = [native_trace if a == "NATIVE" else a for a in CASES[case]]
    got = run_cli(TS.campaign_main, argv + ["--device", "cpu"],
                  tmp_path / "port.json", capsys)
    want = run_cli(RS.campaign_main, argv, tmp_path / "ref.json", capsys)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[0]["table"] and not got[0]["missing_cells"]


#: bad input: (argv, the reference's outcome class)
BAD_ARGVS = [
    ["--strategies", "warp"],
    ["--schedulers", "lifo"],
    ["--size-mix", "nope", "--jobs", "5"],
    ["--deadline-slack", "1"],
    ["--window", "5"],
    ["--stride", "2", "--trace", ALIBABA],
    ["--trace", ALIBABA, "--jobs", "5"],
    ["--trace", ALIBABA, "--window", "5", "--seeds", "0,1"],
    ["--trace", ALIBABA, "--window", "0"],
    ["--events", "bogus=1"],
    ["--events", "preempt=x"],
    ["--events", "preempt=-1"],
    ["--link-speeds", "leaf=0"],
    ["--link-speeds", "nic=nan"],
    ["--link-speeds", "leaf=x"],
    ["--link-speeds", "spine=100"],
    ["--gpu-mix", "h100:1.0:0.7"],
    ["--gpu-mix", "h100:x:1"],
    ["--gpu-mix", "h100:1.0"],
    ["--gpu-mix", "h100:0:1"],
    ["--gpu-mix", "a:1:0.5,b:1:0.5,c:1:1e-12"],
    ["--cell-timeout", "0"],
    ["--max-retries", "-1"],
]


def _exit(main, argv, capsys):
    """(kind, code or message, last stderr line)."""
    try:
        main(argv)
    except SystemExit as e:
        return ("exit", e.code, capsys.readouterr().err.splitlines()[-1])
    except ValueError as e:
        return ("ValueError", str(e), "")
    return ("ok", None, "")


@pytest.mark.parametrize("argv", BAD_ARGVS, ids=" ".join)
def test_sweep_campaign_refuses_as_the_reference(argv, capsys):
    small = ["--jobs", "5"] if "--trace" not in argv and "--jobs" not in argv \
        and "--size-mix" not in argv else []
    got = _exit(TS.campaign_main, argv + small + ["--device", "cpu"], capsys)
    want = _exit(RS.campaign_main, argv + small, capsys)
    assert got == want
    assert got[0] != "ok"


def _bad_trace(tmp_path, rows):
    path = tmp_path / "bad.csv"
    path.write_text("job_id,model,num_gpus,batch_size,arrival,num_iters,"
                    "allreduce_algo,deadline\n" + rows)
    return str(path)


@pytest.mark.parametrize("rows,extra", [
    ("0,vgg16,8,32,nan,100,ring,\n", []),
    ("x,vgg16,8,32,0.0,100,ring,\n", []),
    ("0,vgg16,8,32,0.0,100,ring,\n1,vgg16,8,32,-5,100,ring,\n", []),
    ("0,vgg16,8,32,0.0,100,ring,\n1,bert,8,32,1.0,100,ring,\n",
     ["--trace-format", "alibaba"]),
], ids=["nan-arrival", "bad-id", "negative-arrival", "wrong-format"])
def test_sweep_campaign_bad_trace_exits_2(tmp_path, capsys, rows, extra):
    argv = ["--trace", _bad_trace(tmp_path, rows), "--strategies", "ecmp",
            *extra]
    got = _exit(TS.campaign_main, argv + ["--device", "cpu"], capsys)
    want = _exit(RS.campaign_main, argv, capsys)
    assert got == want and got[:2] == ("exit", 2)


def test_windowed_malformed_stream_exits_2(tmp_path, capsys):
    """A task group reappearing mid-stream is a usage error in both, read
    before the first window in the port."""
    path = tmp_path / "ali.csv"
    rows = ["job_name,task_name,inst_num,plan_gpu,start_time,end_time"]
    rows += [f"j{i},worker,1,100,{10 * i},{10 * i + 500}" for i in range(12)]
    rows.append("j3,worker,1,100,200,700")
    path.write_text("\n".join(rows) + "\n")
    argv = ["--trace", str(path), "--trace-format", "alibaba", "--window",
            "4", "--strategies", "ecmp"]
    got = _exit(TS.campaign_main, argv + ["--device", "cpu"], capsys)
    want = _exit(RS.campaign_main, argv, capsys)
    assert got == want and got[:2] == ("exit", 2)
    assert "reappears" in got[2]


def test_journal_mismatch_exits_2(tmp_path, capsys):
    jp = str(tmp_path / "j.jsonl")
    TS.campaign_main(BASE + ["--journal", jp, "--device", "cpu"])
    capsys.readouterr()
    argv = BASE[:-4] + ["--jobs", "30", "--max-gpus", "64", "--resume", jp]
    got = _exit(TS.campaign_main, argv + ["--device", "cpu"], capsys)
    want = _exit(RS.campaign_main, argv, capsys)
    assert got == want and got[:2] == ("exit", 2)
    assert "different campaign" in got[2]


def test_list_strategies_matches_reference(capsys):
    TS.campaign_main(["--list-strategies"])
    got = capsys.readouterr().out
    RS.campaign_main(["--list-strategies"])
    assert got == capsys.readouterr().out


# ---------------------------------------------------------------------------
# journals cross packages
# ---------------------------------------------------------------------------

def _partial_journal(main, jp, extra, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_CHAOS", "raise@1")
    main(BASE + ["--quarantine", "--journal", jp] + extra)
    monkeypatch.delenv("REPRO_CHAOS")
    assert "QUARANTINED" in capsys.readouterr().out


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_journal_resumes_across_packages(writer, reader, tmp_path,
                                         monkeypatch, capsys):
    mains = {"ref": (RS.campaign_main, []),
             "port": (TS.campaign_main, ["--device", "cpu"])}
    clean, _ = run_cli(RS.campaign_main, BASE, tmp_path / "clean.json",
                       capsys)
    jp = str(tmp_path / "j.jsonl")
    _partial_journal(mains[writer][0], jp, mains[writer][1], monkeypatch,
                     capsys)
    main, extra = mains[reader]
    merged, _ = run_cli(main, BASE + ["--resume", jp] + extra,
                        tmp_path / "merged.json", capsys)
    # the journal held every cell but the quarantined one
    assert merged.pop("resumed_cells") == 5
    assert clean.pop("resumed_cells") == 0
    assert merged == clean


def test_journal_schema_matches_reference():
    """Grid, cluster, store, per-slice fingerprints (churn events included)
    and the result-affecting knobs serialise to the reference's schema, with
    no device in it."""
    schemas = {}
    for name, pkg, runtime in (("port", T, TR), ("ref", R, R.runtime)):
        wl = pkg.WorkloadSpec(num_jobs=20, max_gpus=64, preempt_fraction=0.1)
        grid = pkg.CampaignGrid(strategies=("ecmp", "sr"),
                                loads=(120.0, 60.0), seeds=(0, 1))
        cfg = pkg.SimConfig(ilp_time_limit=1.5, defrag_interval=600.0)
        cells = []
        for s, q, lo, sd in grid.cells():
            w = wl.with_load(lo).with_seed(sd)
            trace = pkg.generate_trace(w)
            events = tuple(pkg.generate_events(w, trace, pkg.CLUSTER512))
            cells.append(runtime.CampaignCell(
                s, q, lo, sd, pkg.CLUSTER512, trace,
                dataclasses.replace(cfg, strategy=s, scheduler=q, seed=sd,
                                    events=events)))
        schemas[name] = json.dumps(runtime.journal_schema(
            pkg.CLUSTER512, pkg.CLUSTER512_OCS, grid, cfg, cells),
            sort_keys=True)
    assert schemas["port"] == schemas["ref"]
    assert "device" not in schemas["port"]


# ---------------------------------------------------------------------------
# twins of tests/test_campaign.py's campaign tests, on device="cpu"
# ---------------------------------------------------------------------------

def test_campaign_grid_validation():
    with pytest.raises(ValueError, match="unknown strategy"):
        T.CampaignGrid(strategies=("warp",))
    with pytest.raises(ValueError, match="queueing policy"):
        T.CampaignGrid(schedulers=("lifo",))
    grid = T.CampaignGrid(strategies=("best", "sr"),
                          schedulers=("fifo", "ff"), loads=(100.0, 200.0),
                          seeds=(0, 1, 2))
    assert grid.size == 2 * 2 * 2 * 3 == len(list(grid.cells()))
    assert list(grid.cells()) == list(R.CampaignGrid(
        strategies=("best", "sr"), schedulers=("fifo", "ff"),
        loads=(100.0, 200.0), seeds=(0, 1, 2)).cells())


def test_campaign_runs_and_aggregates():
    grid = T.CampaignGrid(strategies=("best", "ecmp"), loads=(200.0,),
                          seeds=(0, 1))
    res = T.run_campaign(T.CLUSTER512, grid,
                         workload=T.WorkloadSpec(num_jobs=40, max_gpus=64),
                         device="cpu")
    assert len(res.cells) == grid.size
    rows = res.aggregate()
    assert len(rows) == 2
    by_strat = {r["strategy"]: r for r in rows}
    assert by_strat["best"]["seeds"] == 2
    assert by_strat["best"]["n_finished"] == 80
    assert by_strat["best"]["jct_mean"] <= by_strat["ecmp"]["jct_mean"]
    assert by_strat["best"]["contention_ratio_mean"] <= \
        by_strat["ecmp"]["contention_ratio_mean"] + 1e-9
    for row in rows:
        assert tuple(row) == T.AGGREGATE_COLUMNS
    assert T.AGGREGATE_COLUMNS == R.AGGREGATE_COLUMNS


def test_campaign_cdfs_and_json():
    grid = T.CampaignGrid(strategies=("ecmp",), loads=(200.0,), seeds=(0,))
    res = T.run_campaign(T.CLUSTER512, grid,
                         workload=T.WorkloadSpec(num_jobs=30, max_gpus=64),
                         device="cpu")
    curve = res.contention_cdf("ecmp")
    assert curve
    xs = [x for x, _ in curve]
    ys = [y for _, y in curve]
    assert xs == sorted(xs) and ys == sorted(ys)
    assert ys[-1] == pytest.approx(1.0)
    assert min(xs) >= 1.0 - 1e-9
    assert "jct_cdfs" in json.dumps(res.to_json())


def test_campaign_parallel_workers_match_serial():
    grid = T.CampaignGrid(strategies=("ecmp", "sr"), loads=(150.0,),
                          seeds=(0, 1))
    wl = T.WorkloadSpec(num_jobs=40, max_gpus=64)
    ser = T.run_campaign(T.CLUSTER512, grid, workload=wl, device="cpu")
    par = T.run_campaign(T.CLUSTER512, grid, workload=wl, workers=2,
                         device="cpu")
    assert [(c.strategy, c.scheduler, c.load, c.seed) for c in ser.cells] \
        == [(c.strategy, c.scheduler, c.load, c.seed) for c in par.cells]
    for a, b in zip(ser.cells, par.cells):
        assert a.report.jcts == b.report.jcts
        assert a.report.jwts == b.report.jwts


def test_campaign_streaming_store():
    grid = T.CampaignGrid(strategies=("ecmp",), loads=(150.0,), seeds=(0, 1))
    wl = T.WorkloadSpec(num_jobs=60, max_gpus=64)
    full = T.run_campaign(T.CLUSTER512, grid, workload=wl, device="cpu")
    stream = T.run_campaign(T.CLUSTER512, grid, workload=wl, store="stream",
                            device="cpu")
    for c in stream.cells:
        assert c.report.condensed
        assert len(c.report.jcts) <= 512
    rf = full.aggregate()[0]
    rs = stream.aggregate()[0]
    assert rs["jct_mean"] == pytest.approx(rf["jct_mean"], rel=1e-12)
    assert rs["queue_delay_mean"] == pytest.approx(rf["queue_delay_mean"],
                                                   rel=1e-12)
    assert rs["contention_ratio_mean"] == pytest.approx(
        rf["contention_ratio_mean"], rel=1e-12)
    assert rs["jct_p99"] == pytest.approx(rf["jct_p99"], rel=0.05)
    json.dumps(stream.to_json())
    with pytest.raises(ValueError, match="store"):
        T.run_campaign(T.CLUSTER512, grid, workload=wl, store="bogus",
                       device="cpu")


def test_campaign_explicit_trace():
    trace = T.generate_trace(T.WorkloadSpec(num_jobs=30, max_gpus=64,
                                            seed=3))
    grid = T.CampaignGrid(strategies=("sr",), loads=(120.0,), seeds=(0,))
    res = T.run_campaign(T.CLUSTER512, grid, trace=trace, device="cpu")
    assert res.cells[0].report.n_finished == 30
    with pytest.raises(ValueError, match="loads axis"):
        T.run_campaign(T.CLUSTER512,
                       T.CampaignGrid(strategies=("sr",), loads=(1.0, 2.0)),
                       trace=trace, device="cpu")


@pytest.mark.parametrize("engine", ["v2", "batched"])
def test_campaign_golden_through_run_campaign(engine):
    """The golden trace as a campaign: the pinned average JCTs and the
    reference's reports, on the v2 and the lane engine."""
    grid = T.CampaignGrid(strategies=("ecmp", "sr", "best"), loads=(120.0,),
                          seeds=(0,))
    wl = T.WorkloadSpec(num_jobs=200, max_gpus=256)
    res = T.run_campaign(T.CLUSTER512, grid, workload=wl, engine=engine,
                         device="cpu")
    ref = R.run_campaign(R.CLUSTER512, R.CampaignGrid(
        strategies=("ecmp", "sr", "best"), loads=(120.0,), seeds=(0,)),
        workload=R.WorkloadSpec(num_jobs=200, max_gpus=256), engine=engine)
    assert {c.strategy: round(c.report.avg_jct, 1) for c in res.cells} == \
        {"ecmp": 13417.8, "sr": 3731.4, "best": 2949.3}
    assert drop_wall(res.to_json()) == drop_wall(ref.to_json())


def test_cells_carry_the_device_to_the_simulator(monkeypatch):
    """``device`` reaches ``simulate`` in each cell and ``run_lanes`` on the
    batched branch; ``SimConfig`` stays free of it."""
    from repro_torch.core import batched as TB
    from repro_torch.core import campaign as TC
    seen = []
    real_sim, real_lanes = TC.simulate, TB.run_lanes
    monkeypatch.setattr(TC, "simulate", lambda *a, device=None, **k: (
        seen.append(("simulate", device)), real_sim(*a, device=device,
                                                    **k))[1])
    monkeypatch.setattr(TB, "run_lanes", lambda *a, device=None, **k: (
        seen.append(("run_lanes", device)), real_lanes(*a, device=device,
                                                       **k))[1])
    grid = T.CampaignGrid(strategies=("ecmp",), loads=(120.0,), seeds=(0,))
    wl = T.WorkloadSpec(num_jobs=10, max_gpus=64)
    for engine in ("v2", "batched"):
        T.run_campaign(T.CLUSTER512, grid, workload=wl, engine=engine,
                       device="cpu")
    assert seen == [("simulate", "cpu"), ("run_lanes", "cpu")]
    assert "device" not in {f.name for f in dataclasses.fields(T.SimConfig)}
    assert np.array_equal(
        [f.name for f in dataclasses.fields(T.SimConfig)],
        [f.name for f in dataclasses.fields(R.SimConfig)])
