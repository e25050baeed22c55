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
  shapes alone: the attention variant ``check_layout`` names (every 16-bit
  head_dim on a ``wgmma`` variant, the split kernel float32's alone), the
  column-block kernel's launch plan at the plan's edges and its fit at
  every 16-bit head_dim, the rows' alignment its cp.async route copies at,
  the recurrence's launch plan (the serving paths' plans unchanged, every
  K, V and chunk in range fitting), and the refusals at the ranges' ends.

On the card the kernels are held against their plain versions over the same
shapes: ``-m gpu tests/test_torch_gpu.py -k coverage``.
"""

import re
import shutil

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
    (2, 1, "wgmma_cp_async"), (2, 100, "wgmma_cp_async"),
    (2, 200, "wgmma_cols"), (2, 256, "wgmma_cols"), (2, 320, "wgmma_cols"),
    (2, 512, "wgmma_cols"),
    (4, 8, "mma_split"), (4, 48, "mma_split"), (4, 100, "mma_split"),
    (4, 256, "mma_split"), (4, 512, "mma_split"), (4, 64, "mma_fma"),
    (2, 192, "wgmma_tma"), (2, 264, "wgmma_cols"), (2, 384, "wgmma_cols"),
    (2, 99, "wgmma_cp_async"), (2, 511, "wgmma_cp_async"),
    (4, 1, "mma_split"), (4, 192, "mma_fma"),
])
def test_check_layout_names_the_variant_at_every_head_dim(elt, hd, variant):
    """The variant each head_dim takes on contiguous q / k / v: 16-bit
    multiples of 8 up to 192 on the wgmma kernel (16 and 32 on mma.sync),
    above 192 on the column-block kernel by TMA, the other 16-bit head dims
    (rows off 16 bytes: hd 100 is 200-byte rows) on its cp.async route;
    float32 off the seven instances on the split kernel."""
    shapes, strides, bases = _contiguous(hd, elt)
    assert fa.check_layout(shapes, strides, elt, bases) == variant


@pytest.mark.parametrize("elt,hd", [(4, 64), (4, 192), (2, 16), (2, 32)])
def test_rows_off_16_bytes_take_the_split_kernel(elt, hd):
    """The mma kernel's head dims on rows off 16 bytes (a view one element
    into its buffer): float32 goes to the split kernel, 16-bit to the
    column-block kernel's cp.async route (no longer the split kernel), as
    do the wgmma kernel's head dims (which raised before that route: its
    TMA maps need 16-byte rows)."""
    shapes, strides, bases = _contiguous(hd, elt)
    assert fa.check_layout(shapes, strides, elt, [b + elt for b in bases]) \
        == ("mma_split" if elt == 4 else "wgmma_cp_async")
    shapes, strides, bases = _contiguous(64, 2)
    assert fa.check_layout(shapes, strides, 2, [b + 2 for b in bases]) \
        == "wgmma_cp_async"


def test_split_kernel_fits_at_every_head_dim():
    """The split kernel, float32's alone now, lays out Q at hd padded to 64,
    a K chunk, 128 V columns and the warps' P rows: the count fits a CTA
    from head_dim 1 to 512, and equals ``split::Plan::bytes`` (the card's
    ``test_built_dispatch_matches_check_layout`` holds the library to it)
    at the pinned head dims."""
    sizes = [fa.split_smem_bytes(hd) for hd in range(1, fa.MAX_HEAD_DIM + 1)]
    assert max(sizes) == sizes[-1] <= fa.MAX_SMEM
    assert {hd: fa.split_smem_bytes(hd) for hd in (1, 64, 100, 512)} == {
        1: 86016, 64: 86016, 100: 102400, 512: 200704}


# the column-block kernel's plans at the plan's edges, by route: (boxes,
# width, keys a tile, stages, bytes, blocks).  By TMA: 200 the first head
# dim (4 boxes, two blocks of 128), 256, 264 / 320 the first and last of 5
# boxes (two blocks of 192, 32-key tiles), 328 the first of 8, 392 the
# first of three blocks, 512.  By cp.async also 1 / 99 / 100 / 128 (2
# boxes, one block of 128) and 192 (3 boxes, one block of 192).
COLS_PLANS = {
    1: (2, 128, 64, 4, 164968, [(0, 1)]),
    99: (2, 128, 64, 4, 164968, [(0, 99)]),
    100: (2, 128, 64, 4, 164968, [(0, 100)]),
    128: (2, 128, 64, 4, 164968, [(0, 128)]),
    192: (3, 192, 64, 3, 197712, [(0, 192)]),
    200: (4, 128, 64, 3, 214096, [(0, 128), (128, 72)]),
    256: (4, 128, 64, 3, 214096, [(0, 128), (128, 128)]),
    264: (5, 192, 32, 4, 214120, [(0, 192), (192, 72)]),
    320: (5, 192, 32, 4, 214120, [(0, 192), (192, 128)]),
    328: (8, 192, 32, 2, 222264, [(0, 192), (192, 136)]),
    384: (8, 192, 32, 2, 222264, [(0, 192), (192, 192)]),
    392: (8, 192, 32, 2, 222264, [(0, 192), (192, 192), (384, 8)]),
    512: (8, 192, 32, 2, 222264, [(0, 192), (192, 192), (384, 128)]),
}


@pytest.mark.parametrize("hd", list(COLS_PLANS))
def test_cols_plan_at_the_plans_edges(hd):
    """Each edge's plan on the cp.async route at every copy width and, above
    192, by TMA; a stage more would not fit (or the ring is at its most)."""
    boxes, width, bk, stages, smem, blocks = COLS_PLANS[hd]
    for align in ((0, 16, 8, 2) if hd > 192 else (16, 8, 4, 2)):
        assert fa.plan(hd, align) == {
            "boxes": boxes, "width": width, "bk": bk, "stages": stages,
            "bq": 128, "align": align, "smem": smem, "blocks": blocks}
    assert (width, bk) == fa.cols_instance(boxes)
    assert smem == fa.cols_smem_bytes(boxes, width, bk, stages)
    assert fa.cols_smem_bytes(boxes, width, bk, stages + 1) > fa.MAX_SMEM \
        or stages == fa.MAX_STAGES


def test_every_16_bit_head_dim_runs_on_wgmma_with_a_plan_that_fits():
    """Every 16-bit head_dim 1-512 on aligned and unaligned rows takes a
    ``wgmma`` variant, never the split kernel; multiples of 8 on 16-byte
    rows take a TMA one (16 and 32 aside).  Where the column-block kernel
    takes it, its plan's boxes hold hd, its blocks cover hd exactly at the
    instance's width (a multiple of 8, at most 192, the fewest such
    blocks), its ring has at least two stages, and it fits a CTA's 227
    KB."""
    for hd in range(1, fa.MAX_HEAD_DIM + 1):
        for aligned in (True, False):
            variant = fa.variant_of(2, hd, aligned)
            assert variant in ("wgmma_tma", "wgmma_cols", "wgmma_cp_async",
                               "mma_sync"), (hd, aligned)
            if aligned and hd % 8 == 0 and hd not in (16, 32):
                assert variant in ("wgmma_tma", "wgmma_cols"), hd
            if variant not in fa.COLS_VARIANTS:
                continue
            pl = fa.plan(hd, 0 if variant == "wgmma_cols" else 2)
            width, blocks = pl["width"], pl["blocks"]
            # the route's least instance that holds hd
            assert pl["boxes"] in fa.COLS_BOXES[variant]
            assert 64 * pl["boxes"] >= hd
            assert all(64 * b < hd for b in fa.COLS_BOXES[variant]
                       if b < pl["boxes"])
            assert (width, pl["bk"]) == fa.cols_instance(pl["boxes"])
            assert width % 8 == 0 and width <= fa.COLS_MAX_WIDTH
            assert len(blocks) == -(-hd // fa.COLS_MAX_WIDTH)
            assert [c for c, _ in blocks] == list(range(0, hd, width))
            assert sum(n for _, n in blocks) == hd
            assert all(0 < n <= width for _, n in blocks)
            assert 2 <= pl["stages"] <= fa.MAX_STAGES
            assert pl["smem"] == fa.cols_smem_bytes(
                pl["boxes"], width, pl["bk"], pl["stages"])
            assert pl["smem"] <= fa.MAX_SMEM == 232448


@pytest.mark.parametrize("off,stride_pad,align", [
    (0, 0, 16), (8, 0, 8), (4, 0, 4), (2, 0, 2), (0, 4, 8), (0, 1, 2),
])
def test_row_align_is_the_widest_copy_every_row_allows(off, stride_pad,
                                                       align):
    """The cp.async route copies at the rows' alignment: a base ``off``
    bytes off 16, or k's row stride ``stride_pad`` elements (2 bytes each)
    longer, cut the copies to 8, 4 or 2 bytes."""
    shapes, strides, bases = _contiguous(64, 2)
    strides = [list(st) for st in strides]
    strides[1][1] += stride_pad
    assert fa.row_align(shapes, strides, 2, [b + off for b in bases]) == align
    variant = fa.check_layout(shapes, strides, 2, [b + off for b in bases])
    assert variant == ("wgmma_tma" if align == 16 else "wgmma_cp_async")


def test_contiguous_head_dims_off_8_rows_align_as_their_strides_do():
    """hd 100 rows (200 bytes) start on 8 bytes, odd head dims on 2, hd 68
    (136 bytes) on 8: the copies the cp.async route makes there."""
    for hd, align in ((100, 8), (99, 2), (1, 2), (68, 8), (258, 4)):
        shapes, strides, bases = _contiguous(hd, 2)
        assert fa.row_align(shapes, strides, 2, bases) == align, hd
        assert fa.check_layout(shapes, strides, 2, bases) == "wgmma_cp_async"


def test_cols_plan_refuses_what_no_instance_takes():
    """Head dims out of range, copies of no width the rows can have, and a
    TMA plan where the wgmma kernel takes the head_dim (192 and below)."""
    with pytest.raises(ValueError, match="head_dim 513"):
        fa.plan(513)
    with pytest.raises(ValueError, match="3-byte"):
        fa.plan(64, 3)
    with pytest.raises(ValueError, match="head_dim 192, 0-byte"):
        fa.plan(192, 0)


def test_sources_include_only_headers_the_build_hashes(tmp_path,
                                                      monkeypatch):
    """Each kernel source is one library and includes only csrc's headers;
    an edit to a header rebuilds every library, an edit to a source only
    its own."""
    from repro_torch.kernels import build
    assert {"flash_attention", "flash_attention_cols"} <= set(build.sources())
    for src in build.sources().values():
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert inc.endswith(".cuh") and (build.CSRC / inc).exists(), inc
    shutil.copytree(build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")

    def targets():
        return {n: build._target(p) for n, p in build.sources().items()}

    before = targets()
    with open(tmp_path / "csrc" / "rwkv6.cu", "a") as f:
        f.write("\n")
    edited = targets()
    assert {n for n in before if edited[n] != before[n]} == {"rwkv6"}
    with open(tmp_path / "csrc" / "flash_attention.cuh", "a") as f:
        f.write("\n")
    assert all(t != edited[n] for n, t in targets().items())


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
