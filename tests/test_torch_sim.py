"""Port vs reference: the flow-level simulator (``repro_torch.core``).

The port keeps its own copy of the reference's numpy core; these tests hold
each copy against ``repro.core`` so that drift shows:

* the dataclasses (``ClusterSpec`` and its presets, ``SimConfig``,
  ``WorkloadSpec``, ``Job``, ``ClusterEvent``) field by field;
* ``generate_trace`` / ``generate_events``: identical jobs and events for
  seeds 0-2 (the state the slice carries across);
* the engines on ``device="cpu"``, where rate resolution runs the
  segment-max kernel's plain version: identical ``.jcts`` / ``.jwts`` for
  every registered strategy on the golden trace, the pinned goldens on
  engines v1 / v2 / batched, the churn golden of ``tests/test_events.py``,
  one heterogeneous fleet, and ``run_lanes`` report for report on a 12-lane
  grid.  Equality is exact: the schedules are integer- and bit-identical.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.core import batched as RB  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import batched as TB  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402

GOLDEN = {"ecmp": 13417.8, "sr": 3731.4, "best": 2949.3}
#: v2 rate-resolution solves of the golden trace (counted on the reference)
GOLDEN_SOLVES = {"ecmp": 39, "sr": 36, "best": 0}
CHURN_GOLDEN = {"ecmp": 12099.6, "sr": 3937.7, "best": 2887.6}


def _wl(pkg, **kw):
    base = dict(num_jobs=200, mean_interarrival=120.0, seed=0, max_gpus=256)
    base.update(kw)
    return pkg.WorkloadSpec(**base)


def _assert_reports_equal(a, b):
    """Bit-exact schedule equality, as tests/test_batched.py asserts it."""
    assert a.n_finished == b.n_finished
    np.testing.assert_array_equal(np.asarray(a.jcts), np.asarray(b.jcts))
    np.testing.assert_array_equal(np.asarray(a.jwts), np.asarray(b.jwts))
    np.testing.assert_array_equal(np.asarray(a.slowdowns),
                                  np.asarray(b.slowdowns))
    for name in ("frag_gpu", "frag_network", "avg_jct", "avg_jwt",
                 "stability", "makespan", "preemptions", "failures",
                 "resizes", "migrations", "migration_bytes"):
        assert getattr(a, name) == getattr(b, name), name
    assert a.event_log == b.event_log


def _spec_for(pkg, strategy):
    s = pkg.get_strategy(strategy)
    return (pkg.CLUSTER512_OCS if s.requires_ocs or s.wants_ocs_spec
            else pkg.CLUSTER512)


@pytest.fixture(scope="module")
def golden_jobs():
    return R.generate_trace(_wl(R)), T.generate_trace(_wl(T))


_ref_cache = {}


def _ref_run(strategy, jobs):
    """The reference's v2 run of the golden trace, once per strategy."""
    if strategy not in _ref_cache:
        _ref_cache[strategy] = R.simulate(_spec_for(R, strategy), jobs,
                                          strategy)
    return _ref_cache[strategy]


# ---------------------------------------------------------------------------
# drift of the copies
# ---------------------------------------------------------------------------

def _fields(cls):
    return [(f.name, f.default, f.default_factory) for f in
            dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ClusterSpec", "SimConfig", "WorkloadSpec",
                                  "Job", "ClusterEvent", "ModelProfile"])
def test_dataclasses_match_reference(name):
    ref, port = getattr(R, name), getattr(T, name)
    assert [f[0] for f in _fields(port)] == [f[0] for f in _fields(ref)]
    for (n, d, fac), (_, dr, facr) in zip(_fields(port), _fields(ref)):
        assert d == dr, n
        assert (fac is dataclasses.MISSING) == (facr is dataclasses.MISSING)


@pytest.mark.parametrize("preset", ["CLUSTER512", "CLUSTER512_OCS",
                                    "CLUSTER2048", "CLUSTER2048_OCS",
                                    "TESTBED32"])
def test_cluster_presets_match_reference(preset):
    ref, port = getattr(R, preset), getattr(T, preset)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.num_gpus == ref.num_gpus
    assert port.nic_ratio == ref.nic_ratio and port.is_hetero == ref.is_hetero


def test_profiles_and_registry_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in T.PROFILES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R.PROFILES.items()}
    assert T.BATCHES == R.BATCHES and T.SIZE_MIXES == R.SIZE_MIXES
    assert T.strategy_names() == R.strategy_names()
    assert T.ENGINES == R.ENGINES and T.QUEUE_POLICIES == R.QUEUE_POLICIES
    for name in T.strategy_names():
        t, r = T.get_strategy(name), R.get_strategy(name)
        for attr in ("isolated", "grantable", "requires_ocs",
                     "wants_ocs_spec", "memoize_failures",
                     "supports_migration", "queue_policies"):
            assert getattr(t, attr) == getattr(r, attr), (name, attr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traces_and_events_match_reference(seed):
    churn = dict(num_jobs=120, seed=seed, preempt_fraction=0.15,
                 resize_fraction=0.08, server_mtbf=6000.0, link_mtbf=8000.0,
                 fail_duration=2400.0, deadline_slack=(1.5, 4.0))
    rj, tj = R.generate_trace(_wl(R, **churn)), T.generate_trace(_wl(T, **churn))
    assert [dataclasses.asdict(j) for j in tj] == \
        [dataclasses.asdict(j) for j in rj]
    re_ = R.generate_events(_wl(R, **churn), rj, R.CLUSTER512)
    te = T.generate_events(_wl(T, **churn), tj, T.CLUSTER512)
    assert len(te) > 0
    assert [dataclasses.asdict(e) for e in te] == \
        [dataclasses.asdict(e) for e in re_]


def test_config_refuses_what_the_port_does_not_have():
    with pytest.raises(ValueError, match="trace format"):
        T.SimConfig(trace_format="csv")
    with pytest.raises(ValueError, match="unknown strategy"):
        T.SimConfig(strategy="nope")
    with pytest.raises(ValueError, match="size mix"):
        T.generate_trace(T.WorkloadSpec(num_jobs=2, size_mix="nope"))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", R.strategy_names())
def test_every_strategy_matches_reference_v2(golden_jobs, strategy):
    rj, tj = golden_jobs
    ref = _ref_run(strategy, rj)
    rep = T.simulate(_spec_for(T, strategy), tj, strategy, device="cpu")
    _assert_reports_equal(rep, ref)


@pytest.mark.parametrize("engine", ["v1", "v2", "batched"])
@pytest.mark.parametrize("strategy", sorted(GOLDEN))
def test_goldens_on_every_engine(golden_jobs, strategy, engine):
    rj, tj = golden_jobs
    TS.solves = TB.solves = 0
    rep = T.simulate(T.CLUSTER512, tj, strategy, engine=engine, device="cpu")
    assert round(rep.avg_jct, 1) == pytest.approx(GOLDEN[strategy])
    _assert_reports_equal(rep, _ref_run(strategy, rj))
    # the engines count their rate-resolution solves: v2 and the lane
    # engine make the same ones; v1 resolves rates without the segment max
    assert TS.solves + TB.solves == (0 if engine == "v1"
                                     else GOLDEN_SOLVES[strategy])


def test_churn_golden_matches_reference():
    wl = dict(preempt_fraction=0.15, resize_fraction=0.08,
              server_mtbf=6000.0, link_mtbf=8000.0, fail_duration=2400.0)
    rj, tj = R.generate_trace(_wl(R, **wl)), T.generate_trace(_wl(T, **wl))
    rev = tuple(R.generate_events(_wl(R, **wl), rj, R.CLUSTER512))
    tev = tuple(T.generate_events(_wl(T, **wl), tj, T.CLUSTER512))
    for strat, want in CHURN_GOLDEN.items():
        rep = T.simulate(T.CLUSTER512, tj, device="cpu", config=T.SimConfig(
            strategy=strat, events=tev, defrag_interval=10000.0))
        assert round(rep.avg_jct, 1) == pytest.approx(want), strat
        ref = R.simulate(R.CLUSTER512, rj, config=R.SimConfig(
            strategy=strat, events=rev, defrag_interval=10000.0))
        _assert_reports_equal(rep, ref)


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_hetero_fleet_matches_reference(engine):
    """Faster leaf uplinks, slower NICs, mixed GPU generations
    (tests/test_hetero.py's fleet): the speed-aware rate resolution."""
    mix = [("h100", 1.0, 0.5), ("a100", 0.62, 0.5)]

    def het(pkg):
        s = dataclasses.replace(pkg.CLUSTER512, leaf_uplink_gbps=200.0,
                                server_nic_gbps=80.0)
        return pkg.apply_gpu_mix(s, mix)
    kw = dict(num_jobs=80, mean_interarrival=40.0, max_gpus=64, seed=1)
    rj, tj = R.generate_trace(_wl(R, **kw)), T.generate_trace(_wl(T, **kw))
    assert dataclasses.asdict(het(T)) == dataclasses.asdict(het(R))
    for strat in ("ecmp", "sr"):
        ref = R.simulate(het(R), rj, strat, engine=engine)
        rep = T.simulate(het(T), tj, strat, engine=engine, device="cpu")
        _assert_reports_equal(rep, ref)


def test_run_lanes_matches_reference():
    """A 12-lane CLUSTER512 grid (best/sr/ecmp x seeds 0-1 x two loads)
    through the lane engine, report for report."""
    cells = [(s, seed, load) for s in ("best", "sr", "ecmp")
             for seed in (0, 1) for load in (15.0, 35.0)]

    def lanes(pkg):
        return [(pkg.generate_trace(_wl(pkg, num_jobs=90, mean_interarrival=load,
                                        max_gpus=24, seed=seed)),
                 pkg.get_strategy(s), seed) for s, seed, load in cells]
    ref = RB.run_lanes(R.CLUSTER512, lanes(R))
    TB.solves = 0
    reps = T.run_lanes(T.CLUSTER512, lanes(T), device="cpu")
    assert len(reps) == len(ref) == 12
    for a, b in zip(reps, ref):
        _assert_reports_equal(a, b)
    assert TB.solves > 0


def test_engines_refuse_what_the_reference_refuses():
    jobs = T.generate_trace(_wl(T, num_jobs=10, max_gpus=8))
    with pytest.raises(ValueError, match="qualify"):
        T.run_lanes(T.TESTBED32, [(copy.deepcopy(jobs),
                                   T.get_strategy("vclos"), 0)],
                    device="cpu")
    with pytest.raises(ValueError, match="OCS"):
        T.ClusterSimulator(T.CLUSTER512, strategy="ocs-vclos", device="cpu")
    with pytest.raises(ValueError, match="no path"):
        T.phase_worst_loads(np.zeros(1, np.int64), np.asarray([0, 1]),
                            device="meta")
