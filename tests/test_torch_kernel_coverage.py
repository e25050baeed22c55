"""Port vs reference over every shape and dtype the Pallas kernels take.

The Pallas kernels take any head_dim and dtype (attention) and any K, V and
chunk that divides T (the recurrence); so do the port's Hopper kernels, up
to head_dim 512 and K / V 256.  Seeded numpy inputs go to both packages:

* attention: the reference's ``attention(implementation="pallas")``
  (interpret mode on the CPU) against the port's ``ops.attention`` on CPU
  tensors, at head_dim 8, 24, 48, 100, 256 and 320, causal in float32
  (2e-5), bf16 (2e-2) and float16 (2e-3), and non-causal with Sq != Skv and
  windowed at each head_dim;
* the recurrence: ``rwkv6_mix(implementation="pallas")`` without a state,
  the reference's chunk scan with one, against the port's
  ``ops.rwkv6_mix_state`` at (K, V, chunk) (24, 40, 128), (256, 16, 256),
  (64, 128, 128) and (100, 36, 32), with and without a bonus, on decays in
  log U(0.3, 1): output and final state within 1e-5 of their scale, and as
  close to a float64 evaluation as the reference is (the test says why);
* on the CPU, where no kernel runs, the choices the card makes from the
  shapes alone: the attention variant ``check_layout`` names, the
  recurrence's launch plan (the serving paths' plans unchanged, every K, V
  and chunk in range fitting), and the refusals at the ranges' ends.

On the card the kernels are held against their plain versions over the same
shapes: ``-m gpu tests/test_torch_gpu.py -k coverage``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import attention as jax_attention  # noqa: E402
from repro.kernels.ops import rwkv6_mix as jax_rwkv6_mix  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6 as kr  # noqa: E402

ATTN_HEAD_DIMS = (8, 24, 48, 100, 256, 320)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),
          "float16": (jnp.float16, torch.float16, 2e-3)}
# mask name: (causal, window, Skv); Sq is 56
MASKS = {"causal": (True, None, None), "cross": (False, None, 40),
         "window": (True, 24, None)}


def _attn_inputs(seed, hd, dtype, skv=None, b=1, sq=56, hq=4, hkv=2):
    """q (b, sq, hq, hd), k / v (b, skv or sq, hkv, hd): numpy normals
    rounded to ``dtype``, the same values for both frameworks."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for n, h in ((sq, hq), (skv or sq, hkv), (skv or sq, hkv)):
        x = jnp.asarray(rng.normal(size=(b, n, h, hd)), jdt)
        out.append((x, torch.from_numpy(np.array(x, np.float32)).to(tdt)))
    return out


def _attention_case(hd, dtype, mask):
    causal, window, skv = MASKS[mask]
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(hd, hd, dtype, skv)
    ref = jax_attention(jq, jk, jv, causal=causal, window=window,
                        implementation="pallas", block_q=32, block_k=32)
    out = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", ATTN_HEAD_DIMS)
def test_attention_matches_pallas_at_every_head_dim(hd, dtype):
    """Causal GQA (4 / 2 heads) at each head_dim and dtype."""
    _attention_case(hd, dtype, "causal")


@pytest.mark.parametrize("mask", ["cross", "window"])
@pytest.mark.parametrize("hd", ATTN_HEAD_DIMS)
def test_attention_masks_match_pallas_at_every_head_dim(hd, mask):
    """Non-causal with Sq 56 != Skv 40, and a window of 24, at each
    head_dim, the dtype taking turns over the head dims."""
    dtype = list(DTYPES)[ATTN_HEAD_DIMS.index(hd) % 3]
    _attention_case(hd, dtype, mask)


def _contiguous(hd, elt, hq=4, hkv=2, b=2, s=64):
    shapes = [(b, s, h, hd) for h in (hq, hkv, hkv)]
    strides = [(s * h * hd, h * hd, hd, 1) for h in (hq, hkv, hkv)]
    return shapes, strides, [4096, 1 << 20, 1 << 21]


@pytest.mark.parametrize("elt,hd,variant", [
    (2, 8, "wgmma_tma"), (2, 24, "wgmma_tma"), (2, 48, "wgmma_tma"),
    (2, 72, "wgmma_tma"), (2, 112, "wgmma_tma"), (2, 184, "wgmma_tma"),
    (2, 16, "mma_sync"), (2, 32, "mma_sync"),
    (2, 1, "mma_split"), (2, 100, "mma_split"), (2, 200, "mma_split"),
    (2, 256, "mma_split"), (2, 320, "mma_split"), (2, 512, "mma_split"),
    (4, 8, "mma_split"), (4, 48, "mma_split"), (4, 100, "mma_split"),
    (4, 256, "mma_split"), (4, 512, "mma_split"), (4, 64, "mma_fma"),
])
def test_check_layout_names_the_variant_at_every_head_dim(elt, hd, variant):
    """The variant each head_dim takes on contiguous q / k / v: 16-bit
    multiples of 8 up to 192 on the wgmma kernel (16 and 32 on mma.sync),
    the rest and float32 off the seven instances on the split kernel."""
    shapes, strides, bases = _contiguous(hd, elt)
    assert fa.check_layout(shapes, strides, elt, bases) == variant


@pytest.mark.parametrize("elt,hd", [(4, 64), (4, 192), (2, 16), (2, 32)])
def test_rows_off_16_bytes_take_the_split_kernel(elt, hd):
    """The mma kernel's head dims on rows off 16 bytes (a view one element
    into its buffer) go to the split kernel, whose loads are narrower; the
    wgmma kernel's still raise (its TMA maps need the rule)."""
    shapes, strides, bases = _contiguous(hd, elt)
    assert fa.check_layout(shapes, strides, elt,
                           [b + elt for b in bases]) == "mma_split"
    shapes, strides, bases = _contiguous(64, 2)
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_layout(shapes, strides, 2, [b + 2 for b in bases])


def test_split_kernel_fits_at_every_head_dim():
    """The split kernel's shared memory (Q at hd padded to 64, a K chunk,
    128 V columns, float32's P rows) fits a CTA from head_dim 1 to 512."""
    for elt in (2, 4):
        sizes = [fa.split_smem_bytes(elt, hd)
                 for hd in range(1, fa.MAX_HEAD_DIM + 1)]
        assert max(sizes) == sizes[-1] <= kr.MAX_SMEM
    assert fa.split_smem_bytes(4, 512) == 200704


@pytest.mark.parametrize("hd", [0, 513])
def test_check_layout_refuses_head_dims_out_of_range(hd):
    shapes, strides, bases = _contiguous(max(hd, 1), 2)
    shapes = [sh[:3] + (hd,) for sh in shapes]
    with pytest.raises(ValueError, match="head_dim"):
        fa.check_layout(shapes, strides, 2, bases)


def test_attention_wrapper_refuses_float64():
    """No tensor core computes float64 attention: the wrapper refuses it
    (before it looks at the device, so the CPU can check it)."""
    q = torch.zeros(1, 8, 2, 32, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

# (K, V, chunk) at T 256
RWKV_SHAPES = [(24, 40, 128), (256, 16, 256), (64, 128, 128), (100, 36, 32)]
RWKV_IDS = [f"k{k}-v{v}-c{c}" for k, v, c in RWKV_SHAPES]


def _near(got, ref, truth, scale_of):
    """``got`` within 1e-5 of ``ref`` relative to the output's scale
    (atol 1e-5 x max |ref|, rtol 1e-5), and at most twice as far from the
    float64 ``truth`` as ``ref`` is."""
    got, ref, truth = (np.asarray(x, np.float64) for x in (got, ref, truth))
    scale = np.abs(scale_of).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=1e-5)
    assert np.abs(got - truth).max() <= 2 * np.abs(ref - truth).max() + 1e-7


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("with_bonus", [False, True],
                         ids=["inclusive", "bonus"])
@pytest.mark.parametrize("dk,dv,chunk", RWKV_SHAPES, ids=RWKV_IDS)
def test_recurrence_matches_reference_at_every_shape(dk, dv, chunk,
                                                     with_bonus, with_state):
    """``ops.rwkv6_mix_state`` on the CPU against the reference: without a
    state ``rwkv6_mix(implementation="pallas")`` (interpret mode), with one
    the reference's chunk scan; the final state against the chunk scan.

    Tolerance: 1e-5 of the output's scale, and as close to a float64
    evaluation as the reference is.  A pointwise 1e-5 is below float32's
    own reach here: over 128 or 256 steps of these decays the outputs grow
    to 50-170, the in-chunk cumsum to -120, and each package sums it its
    own way (a sequential sum here, a tree scan in JAX), so the reference
    itself lands up to 3.9e-4 from the float64 result, and the port no
    farther (at chunk 16 both stay within 1e-5)."""
    b, h, t = 1, 2, 256
    rng = np.random.default_rng(dk + dv + chunk + 2 * with_bonus)
    q, k = (rng.normal(size=(b, h, t, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    ld = np.log(rng.uniform(0.3, 1.0, (b, h, t, dk))).astype(np.float32)
    u = ((rng.normal(size=(h, dk)) * 0.2).astype(np.float32)
         if with_bonus else None)
    s0 = (rng.normal(size=(b, h, dk, dv)).astype(np.float32)
          if with_state else None)
    tin = [torch.from_numpy(x) for x in (q, k, v, ld)]
    tu = None if u is None else torch.from_numpy(u)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    out, S = ops.rwkv6_mix_state(*tin, bonus=tu, chunk=chunk,
                                 initial_state=ts0)
    o64, S64 = kr.rwkv6_fused_plain(
        *(x.double() for x in tin), bonus=None if tu is None else tu.double(),
        chunk=chunk, initial_state=None if ts0 is None else ts0.double())
    jf = [jnp.asarray(x) for x in (q, k, v, ld)]
    ju = None if u is None else jnp.asarray(u)
    scan, scan_S = js.chunked_linear_attention(
        *jf, bonus=ju, chunk=chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    if with_state:
        ref = scan
    else:
        ref = jax_rwkv6_mix(*jf, bonus=ju, chunk=chunk,
                            implementation="pallas")
    assert out.shape == (b, h, t, dv) and S.shape == (b, h, dk, dv)
    _near(out.numpy(), ref, o64.numpy(), ref)
    _near(S.numpy(), scan_S, S64.numpy(), scan_S)


# plans the serving and training paths had before sub-blocks existed, which
# must not move: rwkv6-3b's bf16 views at chunk 16, zamba2's float32 Mamba2
# call at chunk 16, K 128 at chunk 64 in float32 (ring does not fit)
KEPT_PLANS = [
    ((64, 64, 16, 2), {"vb": 32, "cs": 16, "threads": 128, "loads": "ring",
                       "smem": 56640, "chunk": 16}),
    ((64, 128, 16, 4), {"vb": 32, "cs": 16, "threads": 128,
                        "loads": "ring", "smem": 70976, "chunk": 16}),
    ((128, 128, 64, 4), {"vb": 32, "cs": 64, "threads": 128,
                         "loads": "direct", "smem": 205568, "chunk": 64}),
]


@pytest.mark.parametrize("shape,want", KEPT_PLANS,
                         ids=["rwkv6-serve", "mamba2-serve", "k128-c64"])
def test_plan_of_the_served_paths_is_unchanged(shape, want):
    assert kr.plan(*shape) == want


def test_plan_at_run_configs_chunk():
    """RunConfig's 128 runs in two sub-blocks of 64 rows: zamba2's float32
    Mamba2 call with direct loads (the ring would not fit), rwkv6-3b's bf16
    views through the ring."""
    assert kr.plan(64, 128, 128, 4) == {
        "vb": 32, "cs": 64, "threads": 128, "loads": "direct",
        "smem": 140800, "chunk": 128}
    assert kr.plan(64, 64, 128, 2) == {
        "vb": 32, "cs": 64, "threads": 128, "loads": "ring",
        "smem": 198144, "chunk": 128}


def test_every_shape_in_range_gets_a_plan_that_fits():
    """Every K and V in 1..256, chunk from 1 to 2048 and element size gets
    a plan in a CTA's shared memory without a ``vb``: NO_SMEM is never
    reached inside the range.  The ring needs K and V rows of whole
    16-byte units."""
    for esize in (2, 4):
        for dk in range(1, kr.MAX_DIM + 1):
            for dv in (1, 7, 8, 24, 40, 100, 128, 256):
                for chunk in (1, 7, 16, 64, 65, 128, 2048):
                    p = kr.plan(dk, dv, chunk, esize)
                    assert 0 < p["smem"] <= kr.MAX_SMEM, (esize, dk, dv, chunk)
                    assert p["cs"] <= min(chunk, kr.MAX_SUB)
                    if p["loads"] == "ring":
                        assert (dk * esize) % 16 == 0 == (dv * esize) % 16
    assert kr.plan(256, 256, 64, 4, vb=64)["smem"] == kr.NO_SMEM
    assert kr.plan(24, 40, 128, 4, rows_aligned=False)["loads"] == "direct"


def _cpu_args(dk=16, dv=16, t=32, dtype=torch.float32):
    rng = np.random.default_rng(0)
    q, k, ld = (torch.from_numpy(rng.normal(size=(1, 2, t, dk))
                                 .astype(np.float32)).to(dtype)
                for _ in range(3))
    v = torch.from_numpy(rng.normal(size=(1, 2, t, dv))
                         .astype(np.float32)).to(dtype)
    return q, k, v, -ld.abs()


@pytest.mark.parametrize("dk,dv,t,chunk,dtype", [
    (24, 40, 256, 128, torch.float32), (256, 16, 256, 256, torch.float32),
    (1, 1, 8, 8, torch.float32), (100, 36, 64, 32, torch.float16),
    (64, 64, 2048, 2048, torch.bfloat16)])
def test_recurrence_wrapper_takes_every_shape_in_range(dk, dv, t, chunk,
                                                       dtype):
    """K and V anywhere in 1..256, a chunk of T itself, float16: every
    shape check passes, and the wrapper stops only at the CPU tensor."""
    before = kr.launches
    with pytest.raises(ValueError, match="CUDA"):
        kr.rwkv6_fused(*_cpu_args(dk, dv, t, dtype), chunk=chunk)
    assert kr.launches == before


@pytest.mark.parametrize("dk,dv,match", [(257, 16, "K=257"),
                                         (16, 257, "V=257")])
def test_recurrence_wrapper_refuses_dims_out_of_range(dk, dv, match):
    with pytest.raises(ValueError, match=match):
        kr.rwkv6_fused(*_cpu_args(dk, dv), chunk=16)


def test_recurrence_wrapper_refuses_float64():
    with pytest.raises(ValueError, match="float64"):
        kr.rwkv6_fused(*_cpu_args(dtype=torch.float64), chunk=16)
