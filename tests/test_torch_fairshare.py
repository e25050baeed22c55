"""Port vs reference: the simulator's solvers (``repro_torch.core.fairshare``
and ``repro_torch.kernels.phase_max``).

* Segment max.  The kernel's plain version (``phase_max_plain``) and the
  engines' entry point ``phase_worst_loads(device="cpu")`` are bit-identical
  to the reference's ``phase_worst_numpy`` and to its Pallas kernel
  ``phase_worst_pallas`` (interpret mode on the CPU) on the cases of
  ``tests/test_kernels.py``, plus negative values.  Values beyond int32 are
  held against numpy only: the Pallas wrapper narrows to int32.
* The engines' route on ``cuda`` stages ``[ptr | vals]`` in one reused
  host buffer (``phase_max.Staging``; page-locked on the card): packing and
  reading back are exact, through growth, after a larger call (no stale
  entries) and beyond int32; the kernel's plain version run on the staged
  views agrees with the reference.
* Water-filling.  ``maxmin_fair_torch(device="cpu")`` agrees with the
  reference's ``maxmin_fair_jax`` within 1e-6 and with ``maxmin_fair_numpy``
  within 1e-6 (1e-9 where the shares are exact in float32), with and
  without a ``flow_cap`` below 1, on the cases of ``tests/test_simulator.py``
  and ``tests/test_hetero.py``.
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fairshare as RF  # noqa: E402
from repro.kernels.phase_max import phase_worst_pallas  # noqa: E402
from repro_torch.core import fairshare as TF  # noqa: E402
from repro_torch.kernels import phase_max as pm  # noqa: E402

I64 = np.iinfo(np.int64)


def _csr(rng, nseg, max_width, lo=-50, hi=50):
    widths = rng.integers(0, max_width + 1, size=nseg)
    ptr = np.concatenate([[0], np.cumsum(widths)])
    vals = rng.integers(lo, hi, size=int(ptr[-1]))
    return vals.astype(np.int64), ptr.astype(np.int64)


def _plain(vals, ptr):
    return pm.phase_max_plain(torch.from_numpy(np.asarray(vals, np.int64)),
                              torch.from_numpy(np.asarray(ptr, np.int64)))


def _all_agree(vals, ptr, pallas=True):
    """Every path equals numpy bit for bit; returns the common result."""
    vals = np.asarray(vals, np.int64)
    ptr = np.asarray(ptr, np.int64)
    want = RF.phase_worst_numpy(vals, ptr)
    got = _plain(vals, ptr)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    loads = TF.phase_worst_loads(vals, ptr, device="cpu")
    assert loads.dtype == np.int64
    np.testing.assert_array_equal(loads, want)
    np.testing.assert_array_equal(TF.phase_worst_numpy(vals, ptr), want)
    if pallas:
        np.testing.assert_array_equal(phase_worst_pallas(vals, ptr), want)
    return want


# ---------------------------------------------------------------------------
# segment max
# ---------------------------------------------------------------------------

def test_segment_max_mixed():
    """Empty, single-entry and wide segments interleaved in one call."""
    got = _all_agree([3, 1, 4, 7, 7, -2, 9], [0, 2, 2, 3, 5, 5, 7])
    assert got.tolist() == [3, 0, 4, 7, 0, 9]


def test_segment_max_empty_links():
    # all-empty segments (idle fabric): every output is 0
    assert _all_agree([], np.zeros(9)).tolist() == [0] * 8
    # zero segments
    assert _all_agree([], [0]).tolist() == []


def test_segment_max_single_job_links():
    # width-1 segments: output is the value itself, negatives preserved
    assert _all_agree([5, -3, 0, 17], np.arange(5)).tolist() == [5, -3, 0, 17]


def test_segment_max_ties():
    assert _all_agree([8, 8, 8, 2, 8, 8], [0, 3, 6]).tolist() == [8, 8]


def test_segment_max_negatives():
    # all-negative segments keep their (negative) max: no clamp to 0
    got = _all_agree([-5, -9, -1, -7, -3, -3], [0, 3, 3, 4, 6])
    assert got.tolist() == [-1, 0, -7, -3]


@pytest.mark.parametrize("nseg,max_width", [
    (1, 1), (127, 5), (129, 3), (7, 130), (200, 40),
])
def test_segment_max_nondivisible_shapes(nseg, max_width):
    rng = np.random.default_rng(nseg * 1000 + max_width)
    _all_agree(*_csr(rng, nseg, max_width))


def test_segment_max_beyond_int32():
    """int64 extremes: the port keeps int64 (the Pallas path narrows to
    int32, so it is left out here)."""
    vals = [I64.min, I64.max, -(2 ** 40), 2 ** 40 + 3, I64.min, I64.min + 1,
            2 ** 31, -(2 ** 31) - 1]
    got = _all_agree(vals, [0, 2, 4, 4, 5, 6, 8], pallas=False)
    assert got.tolist() == [I64.max, 2 ** 40 + 3, 0, I64.min, I64.min + 1,
                            2 ** 31]


@pytest.mark.parametrize("seed", range(8))
def test_segment_max_random_property(seed):
    rng = np.random.default_rng(seed)
    nseg, max_width = int(rng.integers(1, 65)), int(rng.integers(0, 25))
    _all_agree(*_csr(rng, nseg, max_width))


if importlib.util.find_spec("hypothesis") is not None:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=15, deadline=None)
    @given(nseg=st.integers(1, 64), max_width=st.integers(0, 24),
           seed=st.integers(0, 2 ** 16))
    def test_segment_max_property(nseg, max_width, seed):
        rng = np.random.default_rng(seed)
        _all_agree(*_csr(rng, nseg, max_width))


def test_phase_worst_loads_checks_the_csr_on_the_host():
    vals = np.arange(4, dtype=np.int64)
    for ptr in ([1, 4], [0, 3], [0, 3, 2, 4], []):
        with pytest.raises(ValueError, match="CSR"):
            TF.phase_worst_loads(vals, np.asarray(ptr, np.int64),
                                 device="cpu")
    with pytest.raises(TypeError, match="integer"):
        TF.phase_worst_loads(vals.astype(np.float64), np.asarray([0, 4]),
                             device="cpu")
    # int32 input is widened exactly, as the engines' int64 loads are
    np.testing.assert_array_equal(
        TF.phase_worst_loads(vals.astype(np.int32), np.asarray([0, 1, 4]),
                             device="cpu"), [0, 3])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises; it never computes on the
    CPU itself (``phase_worst_loads`` picks the plain version there)."""
    before = pm.launches
    with pytest.raises(ValueError, match="CUDA"):
        pm.phase_max(torch.zeros(3, dtype=torch.int64),
                     torch.tensor([0, 3]))
    assert pm.launches == before


# ---------------------------------------------------------------------------
# the engines' staging buffer ([ptr | vals], reused and grown)
# ---------------------------------------------------------------------------

def _staged_solve(st, vals, ptr):
    """The engines' route on the CPU's terms: pack, run the plain version
    on the staged views into the reused output, read the result back."""
    vals, ptr = np.asarray(vals, np.int64), np.asarray(ptr, np.int64)
    st.pack(vals, ptr)
    sp, sv = st.packed[:len(ptr)], st.packed[len(ptr):len(ptr) + len(vals)]
    np.testing.assert_array_equal(sv, vals)
    np.testing.assert_array_equal(sp, ptr)
    nseg = len(ptr) - 1
    st.out[:nseg] = _plain(sv, sp).numpy()
    got = st.result(nseg)
    np.testing.assert_array_equal(got, RF.phase_worst_numpy(vals, ptr))
    return got


def test_staging_packs_ptr_then_vals_in_one_reused_buffer():
    st = pm.Staging()
    vals, ptr = [3, 1, 4, 7, 7, -2, 9], [0, 2, 2, 3, 5, 5, 7]
    assert _staged_solve(st, vals, ptr).tolist() == [3, 0, 4, 7, 0, 9]
    np.testing.assert_array_equal(st.packed[:len(ptr) + len(vals)],
                                  ptr + vals)
    packed, out = st.packed, st.out
    rng = np.random.default_rng(0)
    for _ in range(5):   # calls that fit reuse both buffers
        _staged_solve(st, *_csr(rng, 40, 20))
        assert st.packed is packed and st.out is out
    assert len(packed) == len(out) == pm.MIN_ENTRIES


@pytest.mark.parametrize("seed", range(3))
def test_staging_growth_keeps_results_exact(seed):
    """Each call larger than the buffers grows them geometrically (at
    least doubled), and every result stays bit-exact."""
    st, rng = pm.Staging(), np.random.default_rng(seed)
    sizes = []
    for nseg in (10, 900, 3000, 7000, 20000):
        vals, ptr = _csr(rng, nseg, 6)
        before = len(st.packed)
        _staged_solve(st, vals, ptr)
        need = len(vals) + len(ptr)
        assert len(st.packed) >= need and len(st.out) >= nseg
        if need > before:
            assert len(st.packed) >= max(2 * before, pm.MIN_ENTRIES)
        sizes.append(len(st.packed))
    assert sizes == sorted(sizes) and len(set(sizes)) <= 5


def test_grown_is_geometric():
    assert pm.grown(0, 1) == pm.MIN_ENTRIES
    assert pm.grown(100, 50) == 100
    assert pm.grown(pm.MIN_ENTRIES, pm.MIN_ENTRIES + 1) == 2 * pm.MIN_ENTRIES
    assert pm.grown(8192, 50000) == 50000
    cap, allocs = 0, 0
    for need in range(1, 1_000_000, 997):
        if pm.grown(cap, need) != cap:
            cap, allocs = pm.grown(cap, need), allocs + 1
    assert allocs <= 10


def test_staging_smaller_call_after_larger_reads_no_stale_values():
    """A large call leaves its values behind in the buffers; a smaller one
    after it must see only its own."""
    st = pm.Staging()
    big_vals = np.full(20000, 10 ** 12, np.int64)
    big_ptr = np.arange(0, 20001, 4, dtype=np.int64)
    _staged_solve(st, big_vals, big_ptr)
    # all-empty segments and short segments: stale 10**12 must not show
    assert _staged_solve(st, [], [0, 0, 0, 0]).tolist() == [0, 0, 0]
    assert _staged_solve(st, [-1, -2, -3], [0, 1, 3]).tolist() == [-1, -2]
    assert _staged_solve(st, [5], [0, 0, 1, 1]).tolist() == [0, 5, 0]
    # what the large call left behind is still there, never read
    assert (st.packed[len(big_ptr):len(big_ptr) + len(big_vals)]
            == 10 ** 12).all()
    assert (st.out[3:len(big_ptr) - 1] == 10 ** 12).all()


def test_staging_keeps_int64_beyond_int32():
    st = pm.Staging()
    vals = [I64.min, I64.max, -(2 ** 40), 2 ** 40 + 3, 2 ** 31,
            -(2 ** 31) - 1, 2 ** 62]
    ptr = [0, 2, 4, 4, 6, 7]
    got = _staged_solve(st, vals, ptr)
    assert got.tolist() == [I64.max, 2 ** 40 + 3, 0, 2 ** 31, 2 ** 62]
    assert st.packed.dtype == np.int64


@pytest.mark.parametrize("nvals,nseg", [(3345, 62), (4758, 84),
                                        (11829, 180), (23566, 444)])
def test_phase_worst_loads_cpu_matches_reference_at_grid_sizes(nvals, nseg):
    """``phase_worst_loads(device="cpu")`` stays bit-identical to the
    reference's numpy and Pallas (interpret) solves at the lane engine's
    call sizes (link loads are small positive counts, within int32)."""
    rng = np.random.default_rng(nvals)
    cuts = np.sort(rng.integers(0, nvals + 1, nseg - 1))
    ptr = np.concatenate([[0], cuts, [nvals]]).astype(np.int64)
    vals = rng.integers(1, 40, nvals).astype(np.int64)
    _all_agree(vals, ptr)


def test_host_route_refuses_without_a_card(monkeypatch):
    """On a machine without a card ``phase_worst_loads`` asks for ``cuda``
    by default and raises; it never falls back to the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = pm.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.phase_worst_loads(np.arange(3), np.asarray([0, 3]))
    assert pm.launches == before


# ---------------------------------------------------------------------------
# max-min water-filling
# ---------------------------------------------------------------------------

def _random_flows(rng, nlinks, nflows):
    return [[int(i) for i in rng.choice(nlinks, size=int(rng.integers(1, 4)),
                                        replace=False)]
            for _ in range(nflows)]


def test_maxmin_torch_simple_cases():
    np.testing.assert_allclose(
        TF.maxmin_fair_torch([["a"], ["a"], ["b"]], device="cpu"),
        [0.5, 0.5, 1.0], atol=1e-9)
    np.testing.assert_allclose(
        TF.maxmin_fair_torch([["l1"], ["l1", "l2"], ["l2"]], device="cpu"),
        [0.5, 0.5, 0.5], atol=1e-9)
    assert TF.maxmin_fair_torch([[], []], flow_cap=0.5,
                                device="cpu").tolist() == [0.5, 0.5]


@pytest.mark.parametrize("trial", range(8))
def test_maxmin_torch_matches_jax_and_numpy(trial):
    rng = np.random.default_rng(100 + trial)
    flows = _random_flows(rng, int(rng.integers(4, 24)),
                          int(rng.integers(5, 60)))
    rt = TF.maxmin_fair_torch(flows, device="cpu")
    np.testing.assert_allclose(rt, np.asarray(RF.maxmin_fair_jax(flows)),
                               atol=1e-6)
    np.testing.assert_allclose(rt, RF.maxmin_fair_numpy(flows), atol=1e-6)
    np.testing.assert_array_equal(TF.maxmin_fair_numpy(flows),
                                  RF.maxmin_fair_numpy(flows))


def test_maxmin_torch_exact_shares_and_capacity_dict():
    exact = [[0]] * 8 + [[1]] * 4 + [[2]] * 2
    np.testing.assert_allclose(TF.maxmin_fair_torch(exact, device="cpu"),
                               RF.maxmin_fair_numpy(exact), atol=1e-9)
    flows = [["a", "b"], ["b"], ["c"], ["a", "c"]]
    cap = {"a": 0.5, "b": 2.0, "c": 1.0}
    np.testing.assert_allclose(
        TF.maxmin_fair_torch(flows, cap, device="cpu"),
        np.asarray(RF.maxmin_fair_jax(flows, cap)), atol=1e-6)


FLOWS = [["a", "b"], ["b"], [], ["a", "c"], ["c"], ["c"]]


@pytest.mark.parametrize("cap", [1.0, 0.8, 0.5, 0.25, 0.3])
def test_maxmin_torch_flow_cap(cap):
    """The NIC ceiling (tests/test_hetero.py): every flow at most ``cap``,
    link-less flows exactly at it, as the reference's solvers."""
    rt = TF.maxmin_fair_torch(FLOWS, flow_cap=cap, device="cpu")
    np.testing.assert_allclose(
        rt, np.asarray(RF.maxmin_fair_jax(FLOWS, flow_cap=cap)), atol=1e-6)
    np.testing.assert_allclose(
        rt, RF.maxmin_fair_numpy(FLOWS, flow_cap=cap), atol=2e-7)
    assert rt.max() <= cap + 1e-7 and rt[2] == np.float32(cap)


def test_maxmin_dispatch(monkeypatch):
    flows = [["a", "b"], ["b"], ["c"]]
    want = RF.maxmin_fair_numpy(flows)
    np.testing.assert_allclose(TF.maxmin_fair(flows), want, atol=1e-9)
    np.testing.assert_allclose(
        TF.maxmin_fair(flows, backend="torch", device="cpu"), want,
        atol=1e-9)
    # below the floor the auto path is numpy and touches no device
    np.testing.assert_array_equal(
        TF.maxmin_fair_auto(flows, device="cpu"), want)
    assert TF.problem_size(flows) == RF.problem_size(flows) == 9
    # the crossover comes from the environment when set, per device
    monkeypatch.setattr(TF, "_crossover", {})
    monkeypatch.setenv("REPRO_MAXMIN_CROSSOVER", "123")
    assert TF.maxmin_crossover(device="cpu") == 123.0
