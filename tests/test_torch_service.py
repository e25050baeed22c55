"""Port vs reference: the online scheduler service (``repro_torch.service``)
and its CLI (``repro_torch.launch.schedd``), on ``device="cpu"``.

* twins of every test of ``tests/test_service.py``: the differential replay
  oracle (with churn), crash-restart, the torn tail, the schema refusal,
  denials, monotonicity, the twin's memo and invalidation, the fork that
  never leaks, the end-to-end server and the malformed-JSON session;
* event logs cross packages: a log written by the reference's
  ``LiveCluster.open`` resumes in the port's to the same version, clock and
  placements, and the other way round;
* the port's server and the reference's answer one scripted sequence of
  wire lines (errors and a malformed line included) byte for byte, once
  ``stats``' wall-clock ``uptime_s`` is dropped;
* ``schedd replay --verify`` exits 0, an injected divergence exits 1, an
  unknown command exits 2; a ``KeyboardInterrupt`` raised inside an op
  propagates out of ``handle``; a fork holds no tensor and solves on the
  live cluster's device.
"""

import copy
import json

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.service as RS  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core import (CLUSTER512, ClusterEvent,  # noqa: E402
                              JournalMismatch, SimConfig, WorkloadSpec,
                              generate_events, generate_trace, save_trace_csv)
from repro_torch.launch import schedd  # noqa: E402
from repro_torch.service import (DigitalTwin, LiveCluster,  # noqa: E402
                                 RecordingSimulator, SchedClient,
                                 SchedulerService, ServerThread,
                                 ServiceError, job_from_json, job_to_json,
                                 replay_trace)
from repro_torch.service.state import PROBE_ID_BASE  # noqa: E402

CFG = dict(scheduler="fifo", seed=0, engine="v2")
DEV = "cpu"


def fresh(jobs):
    """Fresh copies with runtime state reset — both sides of the oracle
    must start from pure input jobs, as ``simulate()`` does."""
    out = [copy.copy(j) for j in jobs]
    for j in out:
        j.start_time = j.finish_time = j.remaining_iters = None
    return out


def trace(n=60, seed=3, **kw):
    return generate_trace(WorkloadSpec(num_jobs=n, mean_interarrival=60.0,
                                       seed=seed, **kw))


def live_cluster(strategy="sr", **kw):
    return LiveCluster(CLUSTER512, SimConfig(strategy=strategy, **CFG),
                       device=DEV, **kw)


def oracle(strategy, jobs, events=()):
    """(service report, service placements) vs (offline report, offline
    placements) on identical inputs."""
    cfg = SimConfig(strategy=strategy, **CFG)
    live = LiveCluster(CLUSTER512, cfg, device=DEV)
    rep_live = replay_trace(live, fresh(jobs), events=events)
    off = RecordingSimulator(
        CLUSTER512, config=cfg.with_overrides(events=tuple(events)),
        device=DEV)
    rep_off = off.run(fresh(jobs))
    return rep_live, live.sim.placements, rep_off, off.placements


# ---------------------------------------------------------------------------
# differential replay oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["ecmp", "sr", "vclos"])
def test_oracle_replay_identical(strategy):
    rep_live, pl_live, rep_off, pl_off = oracle(strategy, trace())
    assert rep_live.to_journal() == rep_off.to_journal()
    assert pl_live == pl_off
    assert len(pl_off) >= 60          # every job placed at least once


@pytest.mark.parametrize("strategy", ["ecmp", "sr"])
def test_oracle_with_churn_events(strategy):
    jobs = trace(50, seed=5)
    wl = WorkloadSpec(num_jobs=50, mean_interarrival=60.0, seed=5,
                      preempt_fraction=0.1, resize_fraction=0.1,
                      server_mtbf=30000.0)
    events = generate_events(wl, jobs, CLUSTER512)
    assert events, "churn spec produced no events — test is vacuous"
    rep_live, pl_live, rep_off, pl_off = oracle(strategy, jobs, events)
    assert rep_live.to_journal() == rep_off.to_journal()
    assert pl_live == pl_off
    assert rep_off.preemptions + rep_off.failures + rep_off.resizes > 0


@pytest.mark.parametrize("strategy", ["ecmp", "sr", "vclos"])
def test_oracle_matches_reference_service(strategy):
    """The port's service loop against the reference's, placement for
    placement, on the same trace."""
    jobs = trace()
    rep_live, pl_live, _, _ = oracle(strategy, jobs)
    ref = RS.LiveCluster(R.CLUSTER512, R.SimConfig(strategy=strategy, **CFG))
    rep_ref = RS.replay_trace(ref, fresh(R.generate_trace(R.WorkloadSpec(
        num_jobs=60, mean_interarrival=60.0, seed=3))))
    assert rep_live.to_journal() == rep_ref.to_journal()
    assert pl_live == ref.sim.placements


def test_report_counts_denied_free():
    live = live_cluster(quotas={"t": 8})
    live.submit(live.new_job("resnet50", 8, 200), tenant="t")
    denied = live.submit(live.new_job("resnet50", 8, 200), tenant="t")
    assert not denied["admitted"]
    live.drain_all()
    rep = live.report()
    assert rep.n_finished == 1 and live.denied == 1


# ---------------------------------------------------------------------------
# durable event log: crash-restart, torn tail, schema guard
# ---------------------------------------------------------------------------

def submit_stream(live, jobs, upto=None):
    for job in fresh(jobs)[:upto]:
        live.submit(job)


def test_crash_restart_replays_to_identical_state(tmp_path):
    jobs = sorted(trace(40, seed=7), key=lambda j: j.arrival)
    cfg = SimConfig(strategy="sr", **CFG)
    path = str(tmp_path / "schedd.log")

    ref = LiveCluster(CLUSTER512, cfg, device=DEV)
    submit_stream(ref, jobs)
    ref.drain_all()

    live = LiveCluster.open(path, CLUSTER512, cfg, fsync=False, device=DEV)
    submit_stream(live, jobs, upto=20)
    del live                                    # no close(): a real crash

    live2 = LiveCluster.open(path, CLUSTER512, cfg, fsync=False, device=DEV)
    assert live2.ingested == 20
    for job in fresh(jobs)[20:]:
        live2.submit(job)
    live2.drain_all()
    assert live2.report().to_journal() == ref.report().to_journal()
    assert live2.sim.placements == ref.sim.placements
    assert live2.version == ref.version
    live2.close()


def test_crash_restart_torn_tail_dropped(tmp_path):
    jobs = sorted(trace(10, seed=1), key=lambda j: j.arrival)
    cfg = SimConfig(strategy="ecmp", **CFG)
    path = str(tmp_path / "schedd.log")
    live = LiveCluster.open(path, CLUSTER512, cfg, fsync=False, device=DEV)
    submit_stream(live, jobs)
    with open(path, "a") as f:
        f.write('{"kind": "submit", "tenant": "defa')
    live2 = LiveCluster.open(path, CLUSTER512, cfg, fsync=False, device=DEV)
    assert live2.ingested == 10                 # torn record dropped
    with open(path) as f:
        assert all(json.loads(ln) for ln in f)  # file healed: all lines parse
    live2.close()


def test_resume_refuses_different_schema(tmp_path):
    path = str(tmp_path / "schedd.log")
    LiveCluster.open(path, CLUSTER512, SimConfig(strategy="sr", **CFG),
                     fsync=False, device=DEV).close()
    with pytest.raises(JournalMismatch, match="strategy"):
        LiveCluster.open(path, CLUSTER512,
                         SimConfig(strategy="ecmp", **CFG), fsync=False,
                         device=DEV)
    with pytest.raises(JournalMismatch, match="quotas"):
        LiveCluster.open(path, CLUSTER512, SimConfig(strategy="sr", **CFG),
                         quotas={"x": 8}, fsync=False, device=DEV)


def test_denied_submits_replay_to_denials(tmp_path):
    path = str(tmp_path / "schedd.log")
    cfg = SimConfig(strategy="sr", **CFG)
    live = LiveCluster.open(path, CLUSTER512, cfg, quotas={"t": 16},
                            fsync=False, device=DEV)
    live.submit(live.new_job("resnet50", 16, 500), tenant="t")
    assert not live.submit(live.new_job("bert", 8, 500),
                           tenant="t")["admitted"]
    live.close()
    live2 = LiveCluster.open(path, CLUSTER512, cfg, quotas={"t": 16},
                             device=DEV)
    assert live2.denied == 1 and len(live2.jobs) == 1
    assert live2.version == live.version
    live2.close()


def _drive(live, jobs, events):
    """A session with submits, a churn event, an advance and a drain."""
    for job in jobs[:15]:
        live.submit(job)
    live.ingest(events[0])
    live.advance((events[0].time + jobs[15].arrival) / 2)
    for job in jobs[15:]:
        live.submit(job)
    live.drain_all()


def _session_inputs(pkg_core):
    jobs = sorted(pkg_core.generate_trace(pkg_core.WorkloadSpec(
        num_jobs=30, mean_interarrival=60.0, seed=11)),
        key=lambda j: j.arrival)
    t = (jobs[14].arrival + jobs[15].arrival) / 2
    ev = pkg_core.ClusterEvent(time=t, kind="preempt", job_id=3,
                               restart_iters=50.0)
    return fresh(jobs), [ev]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_event_log_crosses_packages(tmp_path, writer):
    """A log written by one package resumes in the other to the same
    version, clock and placements (the schema carries no device)."""
    path = str(tmp_path / "schedd.log")
    quotas = {"teamA": 128}
    ref_cfg = R.SimConfig(strategy="sr", **CFG)
    port_cfg = SimConfig(strategy="sr", **CFG)
    if writer == "reference":
        first = RS.LiveCluster.open(path, R.CLUSTER512, ref_cfg,
                                    quotas=quotas, fsync=False)
        _drive(first, *_session_inputs(R))
        first.close()
        second = LiveCluster.open(path, CLUSTER512, port_cfg, quotas=quotas,
                                  fsync=False, device=DEV)
    else:
        first = LiveCluster.open(path, CLUSTER512, port_cfg, quotas=quotas,
                                 fsync=False, device=DEV)
        _drive(first, *_session_inputs(T))
        first.close()
        second = RS.LiveCluster.open(path, R.CLUSTER512, ref_cfg,
                                     quotas=quotas, fsync=False)
    assert second.ingested == first.ingested > 30
    assert (second.version, second.now) == (first.version, first.now)
    assert second.sim.placements == first.sim.placements
    assert second.report().to_journal() == first.report().to_journal()
    second.close()


# ---------------------------------------------------------------------------
# LiveCluster ingestion contracts
# ---------------------------------------------------------------------------

def test_monotonicity_enforced():
    live = live_cluster()
    live.advance(100.0)
    with pytest.raises(ValueError, match="monotonicity"):
        live.submit(live.new_job("resnet50", 8, 100, arrival=50.0))
    with pytest.raises(ValueError, match="monotonicity"):
        live.ingest(ClusterEvent(time=99.0, kind="preempt", job_id=0))
    with pytest.raises(ValueError, match="monotonicity"):
        live.advance(10.0)


def test_rejects_offline_config_knobs():
    ev = ClusterEvent(time=1.0, kind="preempt", job_id=0)
    with pytest.raises(ValueError, match="ingest"):
        LiveCluster(CLUSTER512, SimConfig(strategy="sr", events=(ev,)),
                    device=DEV)
    with pytest.raises(ValueError, match="defrag"):
        LiveCluster(CLUSTER512, SimConfig(strategy="sr", defrag_interval=50),
                    device=DEV)


def test_rejects_probe_range_and_duplicate_ids():
    live = live_cluster()
    job = live.new_job("resnet50", 8, 100)
    live.submit(job)
    with pytest.raises(ValueError, match="duplicate"):
        live.submit(copy.copy(job))
    bad = live.new_job("resnet50", 8, 100)
    bad.job_id = PROBE_ID_BASE + 5
    with pytest.raises(ValueError, match="probe"):
        live.submit(bad)


def test_unknown_model_rejected_at_materialisation():
    live = live_cluster()
    with pytest.raises(ValueError, match="unknown model"):
        live.new_job("gpt17", 8, 100)


def test_job_json_roundtrip():
    job = trace(1, seed=9)[0]
    assert job_from_json(job_to_json(job)) == job
    assert job_from_json(json.loads(json.dumps(job_to_json(job)))) == job


def test_event_json_roundtrip():
    ev = ClusterEvent(time=12.5, kind="resize", job_id=3, new_gpus=32,
                      restart_iters=80.0)
    assert ClusterEvent.from_json(json.loads(json.dumps(ev.to_json()))) == ev


def test_admission_quota_and_feasibility():
    live = live_cluster(quotas={"teamA": 64})
    assert live.admission("default", 512) == (True, "ok")
    ok, reason = live.admission("default", 513)
    assert not ok and "cluster" in reason
    assert live.admission("teamA", 64)[0]
    live.submit(live.new_job("resnet50", 32, 1000), tenant="teamA")
    ok, reason = live.admission("teamA", 64)
    assert not ok and "quota" in reason
    assert live.admission("teamA", 32)[0]


# ---------------------------------------------------------------------------
# digital twin
# ---------------------------------------------------------------------------

def twin_fixture():
    live = live_cluster()
    for job in fresh(trace(12, seed=2)):
        live.submit(job)
    return live, DigitalTwin(live)


def test_twin_memo_hit_same_version():
    live, twin = twin_fixture()
    a = twin.whatif("moe", 32, 2000, strategies=["sr", "ecmp", "vclos"])
    assert not a["cached"] and twin.misses == 1
    assert twin.forks == 4
    b = twin.whatif("moe", 32, 2000, strategies=["sr", "ecmp", "vclos"])
    assert b["cached"] and twin.hits == 1 and twin.forks == 4
    assert {k: v for k, v in a.items() if k != "cached"} \
        == {k: v for k, v in b.items() if k != "cached"}


def test_twin_invalidated_by_version_bump():
    live, twin = twin_fixture()
    a = twin.whatif("moe", 32, 2000)
    v0 = live.version
    live.submit(live.new_job("resnet50", 16, 500))
    assert live.version > v0
    b = twin.whatif("moe", 32, 2000)
    assert not b["cached"] and twin.misses == 2
    assert b["fabric_version"] != a["fabric_version"]


def test_twin_invalidated_by_pure_clock_advance():
    live, twin = twin_fixture()
    twin.whatif("moe", 32, 2000)
    live.advance(live.now + 1.0)
    assert not twin.whatif("moe", 32, 2000)["cached"]


def test_twin_fork_never_leaks_into_live():
    live, twin = twin_fixture()
    before = (live.version, live.now, len(live.sim.running),
              len(live.sim.queue), live.sim.state.num_free_gpus())
    twin.whatif("dlrm", 64, 3000, strategies=["sr", "ecmp"])
    after = (live.version, live.now, len(live.sim.running),
             len(live.sim.queue), live.sim.state.num_free_gpus())
    assert before == after
    assert all(jid < 2_000_000_000 for jid in live.sim.running)


def test_twin_fork_holds_no_tensor_and_solves_on_the_live_device():
    live, twin = twin_fixture()
    fork = twin.fork()
    assert fork.device == live.sim.device == torch.device(DEV)
    assert not any(isinstance(v, torch.Tensor) for v in vars(fork).values())
    assert fork._load is not live.sim._load
    assert fork._heap is not live.sim._heap


def test_twin_matches_reference_twin():
    """The port's what-if answers equal the reference's on the same live
    state, strategy by strategy."""
    live, twin = twin_fixture()
    ref = RS.LiveCluster(R.CLUSTER512, R.SimConfig(strategy="sr", **CFG))
    for job in fresh(R.generate_trace(R.WorkloadSpec(
            num_jobs=12, mean_interarrival=60.0, seed=2))):
        ref.submit(job)
    ask = dict(strategies=["sr", "ecmp", "vclos", "ocs-vclos"])
    assert twin.whatif("moe", 32, 2000, **ask) \
        == RS.DigitalTwin(ref).whatif("moe", 32, 2000, **ask)


def test_twin_prediction_matches_actual_submit():
    live = live_cluster()
    twin = DigitalTwin(live)
    pred = twin.whatif("resnet50", 16, 4000)["strategies"]["sr"]
    assert pred["placed_now"] and pred["predicted_wait"] == 0.0
    r = live.submit(live.new_job("resnet50", 16, 4000))
    assert r["placed"] and r["gpus"] == pred["gpus"]
    (jid, t_fin), = live.drain_all()
    assert t_fin == pytest.approx(pred["predicted_jct"], abs=1e-9)


def test_twin_unsupported_strategy_reported_not_raised():
    live, twin = twin_fixture()
    out = twin.whatif("moe", 32, 2000, strategies=["ocs-vclos"])
    pred = out["strategies"]["ocs-vclos"]
    assert pred["supported"] is False and "OCS" in pred["reason"]


# ---------------------------------------------------------------------------
# the protocol: ops thread, wire, end to end
# ---------------------------------------------------------------------------

def test_keyboard_interrupt_in_an_op_propagates():
    service = SchedulerService(live_cluster())

    def interrupted(req):
        raise KeyboardInterrupt

    service._op_stats = interrupted
    with pytest.raises(KeyboardInterrupt):
        service.handle({"id": 1, "op": "stats"})
    # an Exception stays an answer, and the op thread still serves
    assert service.handle({"id": 2, "op": "nope"})["ok"] is False
    assert service.handle({"id": 3, "op": "admit", "num_gpus": 8})["ok"]
    assert service.errors == 1
    service.close()


def test_ops_run_on_the_service_thread():
    import threading
    service = SchedulerService(live_cluster())
    seen = []
    stats = service._op_stats
    service._op_stats = lambda req: (seen.append(threading.current_thread()),
                                     stats(req))[1]
    service.handle({"op": "stats"})
    service.handle({"op": "stats"})
    assert len(set(seen)) == 1 and seen[0] is not threading.current_thread()
    assert seen[0].name.startswith("schedd-op")
    service.close()


SCRIPT = [   # one wire line each: good requests, errors, a malformed line
    {"id": 1, "op": "stats"},
    {"id": 2, "op": "admit", "tenant": "teamA", "num_gpus": 128},
    {"id": 3, "op": "submit", "tenant": "teamA",
     "job": {"model": "resnet50", "num_gpus": 16, "num_iters": 4000}},
    {"id": 4, "op": "submit", "tenant": "teamA",
     "job": {"model": "bert", "num_gpus": 64, "num_iters": 1000}},
    {"id": 5, "op": "submit", "t": 30.0,
     "job": {"model": "vgg16", "num_gpus": 96, "num_iters": 3000}},
    {"id": 6, "op": "place",
     "job": {"model": "no-such-model", "num_gpus": 8, "num_iters": 100}},
    {"id": 7, "op": "place",
     "job": {"model": "bert", "num_gpus": 8, "num_iters": 100}},
    {"id": 8, "op": "whatif", "strategies": ["sr", "ecmp", "ocs-vclos"],
     "job": {"model": "moe", "num_gpus": 32, "num_iters": 2000}},
    {"id": 9, "op": "whatif", "strategies": ["sr", "ecmp", "ocs-vclos"],
     "job": {"model": "moe", "num_gpus": 32, "num_iters": 2000}},
    "this is not json",
    {"id": 10, "op": "event", "event": {"time": 100.0, "kind": "preempt",
                                        "job_id": 0, "restart_iters": 50.0}},
    {"id": 11, "op": "event", "event": "not an object"},
    {"id": 12, "op": "advance", "t": 200.0},
    {"id": 13, "op": "advance", "t": 10.0},
    {"id": 14, "op": "submit", "job": {"model": "resnet50"}},
    {"id": 15, "op": "frobnicate"},
    ["a", "list"],
    {"op": "stats"},
    {"id": 16, "op": "drain"},
    {"id": 17, "op": "stats"},
    {"id": 18, "op": "shutdown"},
]


def _wire_session(service, server_cls, client_cls):
    server = server_cls(service)
    host, port = server.start()
    out = []
    with client_cls(host, port) as c:
        for item in SCRIPT:
            line = item if isinstance(item, str) else json.dumps(item)
            c._fh.write((line + "\n").encode())
            c._fh.flush()
            out.append(c._fh.readline())
    server.join()
    return out


def _without_uptime(raw: bytes) -> str:
    resp = json.loads(raw)
    if isinstance(resp.get("result"), dict):
        resp["result"].pop("uptime_s", None)
    return json.dumps(resp, sort_keys=True)


def test_wire_answers_match_the_reference_byte_for_byte():
    quotas = {"teamA": 64}
    port = _wire_session(SchedulerService(live_cluster(quotas=quotas)),
                         ServerThread, SchedClient)
    ref = _wire_session(RS.SchedulerService(RS.LiveCluster(
        R.CLUSTER512, R.SimConfig(strategy="sr", **CFG), quotas=quotas)),
        RS.ServerThread, RS.SchedClient)
    assert len(port) == len(ref) == len(SCRIPT)
    errors = sum(not json.loads(r)["ok"] for r in ref)
    assert errors == 7
    for ours, theirs in zip(port, ref):
        assert b'"uptime_s"' in theirs or ours == theirs
        assert _without_uptime(ours) == _without_uptime(theirs)


def test_server_end_to_end(tmp_path):
    live = LiveCluster.open(str(tmp_path / "log"), CLUSTER512,
                            SimConfig(strategy="sr", **CFG),
                            quotas={"teamA": 64}, fsync=False, device=DEV)
    server = ServerThread(SchedulerService(live))
    host, port = server.start()
    with SchedClient(host, port) as c:
        assert c.stats()["version"] == 0
        r = c.submit("resnet50", 16, 4000, tenant="teamA")
        assert r["placed"] and len(r["gpus"]) == 16
        assert not c.admit("teamA", 64)["admit"]
        w = c.whatif("moe", 32, 2000, strategies=["sr", "ecmp"])
        assert w["strategies"]["sr"]["supported"]
        assert c.whatif("moe", 32, 2000,
                        strategies=["sr", "ecmp"])["cached"]
        p = c.place("bert", 8, 100)
        assert p["placed"]
        ev = c.event({"time": 50.0, "kind": "preempt", "job_id": r["job_id"],
                      "restart_iters": 10.0})
        assert ev["kind"] == "preempt" and ev["n_affected"] == 1
        done = c.drain()
        assert done["completed"], "preempted job never finished"
        with pytest.raises(ServiceError, match="unknown op"):
            c.call("frobnicate")
        with pytest.raises(ServiceError, match="monotonicity"):
            c.advance(0.0)
        stats = c.stats()
        assert stats["errors"] == 2 and stats["requests"] > 5
        c.shutdown()
    server.join()


def test_server_protocol_malformed_json_keeps_session():
    server = ServerThread(SchedulerService(live_cluster()))
    host, port = server.start()
    with SchedClient(host, port) as c:
        c._fh.write(b"this is not json\n")
        c._fh.flush()
        resp = json.loads(c._fh.readline())
        assert not resp["ok"] and "bad JSON" in resp["error"]
        assert c.stats()["version"] == 0     # session still alive
        c.shutdown()
    server.join()


def test_async_client_round_trip():
    import asyncio
    from repro_torch.service import AsyncSchedClient
    server = ServerThread(SchedulerService(live_cluster()))
    host, port = server.start()

    async def session():
        c = await AsyncSchedClient.connect(host, port)
        assert (await c.admit("default", 8))["admit"]
        assert (await c.place("bert", 8, 100))["placed"]
        with pytest.raises(ServiceError, match="unknown op"):
            await c.call("frobnicate")
        await c.call("shutdown")
        await c.close()

    asyncio.run(session())
    server.join()


# ---------------------------------------------------------------------------
# the schedd CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("schedd") / "golden.csv"
    save_trace_csv(generate_trace(WorkloadSpec(
        num_jobs=200, mean_interarrival=120.0, seed=0, max_gpus=256)),
        str(path))
    return str(path)


@pytest.mark.parametrize("strategy,jct", [("ecmp", "13417.8"),
                                          ("sr", "3731.4")])
def test_schedd_replay_verify_matches_reference(golden_csv, strategy, jct,
                                                capsys, tmp_path):
    from repro.launch import schedd as rschedd
    argv = ["replay", "--trace", golden_csv, "--strategy", strategy,
            "--verify"]
    schedd.main(argv + ["--device", "cpu", "--event-log",
                        str(tmp_path / "port.log")])
    ours = capsys.readouterr().out
    rschedd.main(argv + ["--event-log", str(tmp_path / "ref.log")])
    theirs = capsys.readouterr().out
    assert f"JCT {jct}s" in ours and "verify: OK" in ours
    assert ours == theirs
    live = LiveCluster.open(str(tmp_path / "ref.log"), CLUSTER512,
                            SimConfig(strategy=strategy, **CFG), device=DEV)
    assert live.ingested == 201          # 200 submits + the final drain
    live.close()


def test_schedd_replay_divergence_exits_1(golden_csv, monkeypatch, capsys):
    import repro_torch.service as service
    replay = service.replay_trace

    def diverging(live, jobs, **kw):
        return replay(live, jobs[:-1], **kw)    # the service loses a job

    monkeypatch.setattr(service, "replay_trace", diverging)
    with pytest.raises(SystemExit) as e:
        schedd.main(["replay", "--trace", golden_csv, "--strategy", "sr",
                     "--verify", "--device", "cpu"])
    assert e.value.code == 1
    assert "VERIFY FAILED" in capsys.readouterr().err


def test_schedd_unknown_command_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        schedd.main(["frobnicate"])
    assert e.value.code == 2
    assert "unknown command 'frobnicate'" in capsys.readouterr().err
    schedd.main([])                           # help, exit 0
    assert "schedd" in capsys.readouterr().out


def test_schedd_flag_misuse_as_the_reference(capsys):
    import argparse

    from repro.launch import schedd as rschedd
    for main, extra in ((schedd.main, ["--device", "cpu"]),
                        (rschedd.main, [])):
        with pytest.raises(argparse.ArgumentTypeError, match="TENANT=GPUS"):
            main(["serve", "--quota", "teamA=lots"] + extra)
    with pytest.raises(SystemExit) as e:
        schedd.main(["serve", "--cluster", "testbed", "--ocs",
                     "--device", "cpu"])
    assert e.value.code == 2
    assert "no OCS variant" in capsys.readouterr().err


def test_schedd_submit_and_whatif_clients(capsys):
    server = ServerThread(SchedulerService(live_cluster()))
    host, port = server.start()
    schedd.main(["submit", "--port", str(port), "--model", "resnet50",
                 "--num-gpus", "16", "--num-iters", "4000"])
    assert json.loads(capsys.readouterr().out)["placed"]
    for cached in (False, True):
        schedd.main(["whatif", "--port", str(port), "--model", "moe",
                     "--num-gpus", "32", "--num-iters", "2000",
                     "--strategies", "sr,ecmp"])
        assert json.loads(capsys.readouterr().out)["cached"] is cached
    with SchedClient(host, port) as c:
        c.shutdown()
    server.join()
