"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card and nvcc; imports no JAX, so it runs where the port
runs.  Elsewhere every test skips (decided inside the ``cuda`` fixture, at
run time).  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Flash attention: bf16 within one bf16 ulp of the output (8e-3 where
|o| < 2; the kernel carries P as bf16 hi + lo halves, so it keeps P's
float32 precision as the plain version does and only the output's own
rounding differs), float32 1e-4 (same f32 arithmetic in another summation
order, no TF32); float16 within one float16 ulp; on the three kernels of the
source (wgmma + TMA for 16-bit head dims that are multiples of 8 up to 192,
mma.sync for 16-bit 16 / 32, FMAs for float32 at its seven widths, the
split kernel for the rest), over head dims 1 to 512 (``HEAD_DIMS``, the
coverage list), at the wgmma kernel's
tile edges (S 1, 127, 129, 1000, 2048), windows that cross them, GQA groups
1 / 4 / 8 and views of a fused qkv projection.  Segment max: bit-exact
against its plain version and numpy, on CUDA tensors and through the
engines' numpy route (page-locked staging the kernel reads in place),
through calls that grow and shrink its buffers, with no device allocation
per call and one launch per solve, and from two threads at once.  The
simulator on ``cuda`` gives schedules identical to ``cpu``, with one kernel
launch per rate-resolution solve; so do the smoke figures and the golden
trace through the scheduler service's loop.  RWKV6 chunked recurrence
(the fused kernel, from raw q / k / v / log decay): output within 1e-4
(float32) or one bf16 ulp (bf16) of its plain version, final state within
1e-4, on K / V from 1 to 256 (``KV_DIMS``, the coverage list), every chunk
that divides T (powers of two, the 12, 7, 13 and 3 that ``_fit_chunk`` or a
caller may give, and chunks above 64 in sub-blocks: RunConfig's 128, whose
forward and grads match autograd through the plain scan at 128), both
masks, at chip_smoke.py's shapes, through every VB and both load paths
(cp.async ring, direct), on the model's ``split_heads`` views without a
copy; a CUDA prefill never calls the float32 precompute; reduced rwkv6-3b
prefill on ``cuda`` of 40, 12 and 7 tokens (chunks 8, 12 and 7) launches
it once per layer and matches ``device="cpu"``.  The hybrid family:
attention at zamba2's head_dim 80 (MHA 32 / 32, GQA, windows, ragged S;
the wgmma kernel in bf16),
the recurrence as ``mamba2_apply`` calls it (float32, inclusive, K 64 /
V 128, q broadcast over the heads), and reduced zamba2's ``generate``
against the CPU with its launches counted.  The audio family: attention
non-causal with Sq != Skv on both kernels ((224, 1500), (1500, 224),
(1, 1500), (129, 63), (300, 1); GQA), at whisper-base's encoder, cross
and decoder shapes, on a cross cache's row view, the Function's grads at
Sq != Skv, and reduced whisper's ``generate`` against the CPU with
3 launches a layer in prefill.  The vlm family: attention at head_dim 96
(phi-3-vision, MHA 32 / 32) and 192 (nemotron-4-340b, GQA 96 / 8) on the
wgmma kernel in bf16 and the FMA kernel in float32, with GQA, windows,
ragged S and Sq != Skv, their shared memory as each kernel's plan sizes
it, the wgmma kernel's 80 / 96 / 192 instances on every case the ring, the
boxes and the masks meet, and reduced phi-3-vision at head_dim 96
with patch embeddings against the CPU with one launch a layer.  Under a
mesh: attention through ``local_map`` on ranks sharing the card, gloo's
collectives on CUDA tensors, and the recurrence on a (1, 1) NCCL mesh
equal to the call with no mesh (both masks, float32 and bf16).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import batched as cb  # noqa: E402
from repro_torch.core import simulator as cs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import phase_max as pm  # noqa: E402
from repro_torch.kernels import rwkv6 as kr  # noqa: E402
from repro_torch.models.transformer import LM, forward  # noqa: E402
from repro_torch.serve.decode import prefill  # noqa: E402

pytestmark = pytest.mark.gpu
F32_TOL = 1e-4
# the coverage lists: head dims and K / V the kernels are held at, across
# every variant and the ranges' ends
HEAD_DIMS = (1, 8, 16, 24, 32, 48, 64, 72, 80, 96, 99, 100, 128, 192, 200,
             256, 264, 320, 384, 512)
KV_DIMS = (1, 7, 8, 16, 24, 32, 40, 64, 100, 128, 200, 256)
PLAN_DIMS = (1, 7, 24, 64, 128, 256)    # K x V x chunk x dtype: the plans
DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def bf16_bound(ref):
    """One bf16 ulp of |ref|, at least 8e-3 (the ulp below 2)."""
    mag = ref.abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp_min(8e-3)


def f16_bound(ref):
    """One float16 ulp of |ref|, at least 2**-10 (the ulp below 2)."""
    mag = ref.abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 10).clamp_min(2 ** -10)


def ulp_bound(ref, dtype):
    """One ulp of the 16-bit output dtype, the kernels' tolerance there."""
    return (bf16_bound if dtype == torch.bfloat16 else f16_bound)(ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, s, hq, hkv, hd, dtype, seed=0, skv=None):
    """q (b, s, hq, hd) and k / v (b, skv or s, hkv, hd)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, n, h, hd, generator=g).to(dev, dtype)
            for n, h in ((s, hq), (skv or s, hkv), (skv or s, hkv))]


def _check(q, k, v, variant=None, **kw):
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    if variant is not None:
        assert fa.last_variant == variant
    ref = fa.flash_attention_plain(q, k, v, kw.get("causal", True),
                                   kw.get("window"))
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    if q.dtype != torch.float32:
        err = (out.float() - ref.float()).abs()
        assert bool((err <= ulp_bound(ref.float(), q.dtype)).all()), \
            err.max().item()
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=F32_TOL,
                                   rtol=F32_TOL)
    return fa.last_variant


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("b,s,hq,hkv", [
    (2, 128, 4, 4),      # MHA
    (1, 256, 8, 2),      # GQA
    (2, 96, 4, 1),       # MQA, ragged seq
])
def test_kernel_matches_plain(cuda, b, s, hq, hkv, hd, dtype):
    _check(*_qkv(cuda, b, s, hq, hkv, hd, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48), (False, 48),
                                           (True, 1)])
def test_kernel_masks(cuda, causal, window, dtype):
    _check(*_qkv(cuda, 1, 300, 4, 2, 64, dtype, seed=1), causal=causal,
           window=window)


def test_kernel_reads_strided_inputs(cuda):
    """q/k/v sliced out of one fused (B, S, Hq + 2 Hkv, hd) buffer."""
    qkv = torch.randn(2, 200, 12, 64, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert not q.is_contiguous()
    _check(q, k, v)


# The wgmma kernel takes 128 q rows a CTA and 128-key tiles (TMA boxes
# zero-filled past S); the mma kernel 64 and 64.

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 127, 129, 1000, 2048])
def test_kernel_tile_edges(cuda, s, dtype):
    variant = "wgmma_tma" if dtype == torch.bfloat16 else "mma_fma"
    _check(*_qkv(cuda, 2, s, 8, 2, 64, dtype, seed=s), variant=variant)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (True, 200), (False, 200)])
@pytest.mark.parametrize("s", [300, 1000])
def test_kernel_windows_across_tile_edges(cuda, s, causal, window, hd,
                                          dtype):
    """Sq not a multiple of 128, windows that start inside a K/V tile."""
    _check(*_qkv(cuda, 1, s, 4, 2, hd, dtype, seed=hd + s), causal=causal,
           window=window)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (16, 2)],
                         ids=["group1", "group4", "group8"])
@pytest.mark.parametrize("hd,variant", [(64, "wgmma_tma"),
                                        (128, "wgmma_tma"),
                                        (16, "mma_sync"), (32, "mma_sync")])
def test_kernel_gqa_groups_and_variants(cuda, hq, hkv, hd, variant):
    _check(*_qkv(cuda, 2, 333, hq, hkv, hd, torch.bfloat16, seed=hq),
           variant=variant)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_kernel_reads_fused_projection_views(cuda, hq, hkv, hd, dtype):
    """q/k/v as strided views of one (B, S, (Hq + 2 Hkv) * hd) tensor, the
    output of a fused qkv projection; each map's rows are (Hq + 2 Hkv) * hd
    apart and k / v start mid-row."""
    b, s = 2, 257
    g = torch.Generator(device="cpu").manual_seed(hd)
    fused = torch.randn(b, s, (hq + 2 * hkv) * hd, generator=g).to(cuda,
                                                                     dtype)
    heads = fused.view(b, s, hq + 2 * hkv, hd)
    q, k, v = heads[:, :, :hq], heads[:, :, hq:hq + hkv], \
        heads[:, :, hq + hkv:]
    assert not (q.is_contiguous() or k.is_contiguous())
    _check(q, k, v)
    _check(q, k, v, causal=True, window=100)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_built_dispatch_matches_check_layout(cuda, hd, dtype):
    """The C side's variant() and the wrapper's check_layout name the same
    variant for every (dtype, head_dim), on 16-byte rows and, where the
    wrapper takes them, on rows off 16 bytes; the split kernel's shared
    memory is the one ``split_smem_bytes`` counts, the column-block
    kernel's the one its ``plan`` counts."""
    q, k, v = _qkv(cuda, 1, 8, 2, 1, hd, dtype)
    named = fa.check_layout([t.shape for t in (q, k, v)],
                            [t.stride() for t in (q, k, v)],
                            q.element_size(),
                            [t.data_ptr() for t in (q, k, v)])
    aligned = fa.variant_of(q.element_size(), hd, True)
    assert fa.built_variant(dtype, hd) == aligned
    if (hd * q.element_size()) % 16 == 0:
        assert named == aligned
    assert fa.smem_bytes(dtype, hd) > 0
    off = fa.variant_of(q.element_size(), hd, False)
    assert fa.built_variant(dtype, hd, aligned=False) == off
    if off == "mma_split":
        assert fa.smem_bytes(dtype, hd, aligned=False) == \
            fa.split_smem_bytes(hd)
    for rows16, named_there in ((True, aligned), (False, off)):
        if named_there in fa.COLS_VARIANTS:
            assert fa.smem_bytes(dtype, hd, rows16) == fa.plan(
                hd, 0 if named_there == "wgmma_cols" else 2)["smem"]


def test_dispatch_sends_cuda_tensors_to_the_kernel(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 32, torch.bfloat16)
    before = fa.launches
    out = ops.attention(q, k, v)
    assert fa.launches == before + 1 and out.is_cuda


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.zeros(1, 64, 4, 513, device=cuda, dtype=torch.bfloat16)
        fa.flash_attention(wide, wide[:, :, :2], wide[:, :, :2])
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3),
                           k, v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :, :3].contiguous(), k, v)


# ---------------------------------------------------------------------------
# coverage: every head_dim and dtype the attention kernels take
# ---------------------------------------------------------------------------

COVER_HEAD_DIMS = (8, 24, 48, 100, 256, 320)
COVER_MASKS = {"causal": (True, None, None), "cross": (False, None, 100),
               "window": (True, 48, None)}   # causal, window, Skv


@pytest.mark.parametrize("mask", list(COVER_MASKS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_coverage_attention_kernel_matches_plain(cuda, hd, dtype, mask):
    """Every head_dim of the coverage list in every dtype, causal,
    non-causal with Sq 200 != Skv 100 and windowed, GQA 8 / 2: the variant
    ``check_layout`` names launches and agrees with the plain version."""
    causal, window, skv = COVER_MASKS[mask]
    q, k, v = _qkv(cuda, 2, 200, 8, 2, hd, dtype, seed=hd, skv=skv)
    ran = _check(q, k, v, causal=causal, window=window)
    assert ran == fa.variant_of(q.element_size(), hd,
                                (hd * q.element_size()) % 16 == 0)


@pytest.mark.parametrize("layout", ["fused", "heads-major", "offset"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", COVER_HEAD_DIMS)
def test_coverage_attention_layouts(cuda, hd, dtype, layout):
    """Non-contiguous inputs at the new head dims: views of one fused qkv
    projection (odd head dims leave its rows off 16 bytes), (B, H, S, hd)
    tensors seen as (B, S, H, hd), and views one element into a buffer
    (rows off 16 bytes: the split kernel takes them in float32, the
    column-block kernel's cp.async route in 16 bits)."""
    b, s, hq, hkv = 2, 257, 8, 2
    g = torch.Generator(device="cpu").manual_seed(hd)
    if layout == "fused":
        x = torch.randn(b, s, (hq + 2 * hkv) * hd, generator=g).to(cuda, dtype)
        x = x.view(b, s, hq + 2 * hkv, hd)
        q, k, v = x[:, :, :hq], x[:, :, hq:hq + hkv], x[:, :, hq + hkv:]
    elif layout == "heads-major":
        q, k, v = (torch.randn(b, h, s, hd, generator=g).to(cuda, dtype)
                   .transpose(1, 2) for h in (hq, hkv, hkv))
    else:
        q, k, v = (torch.randn(b * s * h * hd + 1, generator=g)
                   .to(cuda, dtype)[1:].view(b, s, h, hd)
                   for h in (hq, hkv, hkv))
    named = fa.variant_of(q.element_size(), hd, layout != "offset" and (
        (hq + 2 * hkv if layout == "fused" else 1) * hd
        * q.element_size()) % 16 == 0)
    assert _check(q, k, v) == named
    _check(q, k, v, causal=True, window=100)


# the column-block kernel's plan edges (kernels/flash_attention.py::plan):
# hd 192 (the wgmma kernel's last on 16-byte rows), 200 / 264 the first of
# two blocks at each width, 256, 320 / 384 the last 64-key and first 32-key
# tiles, 512; 1 / 99 / 100 the cp.async route's; (Hq, Hkv) GQA 32 / 8, MHA
COLS_EDGE_DIMS = (1, 99, 100, 192, 200, 256, 264, 320, 384, 512)


@pytest.mark.parametrize("heads", [(32, 8), (8, 8)], ids=["gqa", "mha"])
@pytest.mark.parametrize("mask", list(COVER_MASKS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", COLS_EDGE_DIMS)
def test_coverage_cols_kernel_at_the_plans_edges(cuda, hd, dtype, mask,
                                                 heads):
    """The column-block kernel (by TMA or cp.async; hd 192 on 16-byte rows
    is the wgmma kernel's) at each edge of its plan, causal, non-causal
    with Sq 200 != Skv 100 and windowed: within one output ulp of the plain
    version, through every column block."""
    causal, window, skv = COVER_MASKS[mask]
    hq, hkv = heads
    q, k, v = _qkv(cuda, 1, 200, hq, hkv, hd, dtype, seed=hd, skv=skv)
    ran = _check(q, k, v, causal=causal, window=window)
    assert ran == fa.variant_of(2, hd, hd % 8 == 0)
    if ran in fa.COLS_VARIANTS:
        assert fa.last_plan == fa.plan(hd, fa.last_plan["align"])
        assert fa.last_plan["align"] == (0 if ran == "wgmma_cols"
                                         else fa.row_align(
                                             [t.shape for t in (q, k, v)],
                                             [t.stride() for t in (q, k, v)],
                                             2, [t.data_ptr()
                                                 for t in (q, k, v)]))


def test_coverage_built_variant_at_every_head_dim(cuda):
    """The library's variant() names what the wrapper's variant_of names
    for every head_dim 1-512 in every dtype, on 16-byte rows and not."""
    for dtype in DTYPES:
        esize = torch.tensor([], dtype=dtype).element_size()
        for hd in range(1, fa.MAX_HEAD_DIM + 1):
            for aligned in (True, False):
                assert fa.built_variant(dtype, hd, aligned) == \
                    fa.variant_of(esize, hd, aligned), (dtype, hd, aligned)


@pytest.mark.parametrize("elements_off", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [16, 64, 100, 128, 192, 256, 512])
def test_coverage_cp_async_at_every_alignment(cuda, hd, dtype, elements_off):
    """Views ``elements_off`` 16-bit elements into their buffers (rows on 2,
    4, 8 bytes; 8 elements is 16 bytes again, the TMA variants'): the
    cp.async route copies at the rows' own alignment, causal and windowed,
    GQA 8 / 2, within one output ulp of the plain version."""
    b, s, hq, hkv = 2, 130, 8, 2
    g = torch.Generator(device="cpu").manual_seed(hd + elements_off)
    q, k, v = (torch.randn(b * s * h * hd + elements_off, generator=g)
               .to(cuda, dtype)[elements_off:].view(b, s, h, hd)
               for h in (hq, hkv, hkv))
    align = fa.row_align([t.shape for t in (q, k, v)],
                         [t.stride() for t in (q, k, v)], 2,
                         [t.data_ptr() for t in (q, k, v)])
    if hd % 8 == 0:        # the rows' strides are whole 16-byte units
        assert align == (16 if elements_off == 8 else 2 * elements_off)
    named = fa.variant_of(2, hd, align == 16)
    assert _check(q, k, v) == named
    _check(q, k, v, causal=True, window=50)
    if named == "wgmma_cp_async":
        assert fa.last_plan["align"] == align


def test_prefill_launches_once_per_layer_and_matches_cpu(cuda):
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"),
                          dtype="float32", num_layers=3)
    lm_cpu = LM.init(cfg, seed=2, device="cpu")
    lm_gpu = LM(cfg, lm_cpu.params).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    fa.launches = 0
    with torch.inference_mode():
        logits, state = prefill(lm_gpu.compute_params(), cfg, toks.to(cuda),
                                max_len=48)
        torch.cuda.synchronize()
        assert fa.launches == cfg.num_layers
        ref = forward(lm_cpu.compute_params(), cfg, toks)[0][:, -1:]
    torch.testing.assert_close(logits.cpu(), ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# segment max and the simulator
# ---------------------------------------------------------------------------

I64 = np.iinfo(np.int64)


def _csr(seed, nvals, nseg, lo=1, hi=40):
    """nseg segments over nvals values, empty ones included."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, nvals + 1, max(nseg - 1, 0)))
    ptr = np.concatenate([[0], cuts, [nvals]]).astype(np.int64)
    return rng.integers(lo, hi, nvals).astype(np.int64), ptr


PM_CASES = {   # name -> (vals, ptr)
    # (nvals, nseg) at the batched engine's dispatch
    # (benchmarks/bench_fairshare.py BATCHED_DISPATCH_SHAPES)
    "p50": _csr(0, 3345, 62), "p90": _csr(1, 22652, 398),
    "max": _csr(2, 43593, 753),
    "mixed-empty": ([3, 1, 4, 7, 7, -2, 9], [0, 2, 2, 3, 5, 5, 7]),
    "all-empty": ([], [0] * 9),
    "no-segments": ([], [0]),
    "ties-negatives": ([8, 8, -8, -5, -9, -1, -1], [0, 2, 3, 6, 7]),
    "int64-extremes": ([I64.min, I64.max, I64.min, -(2 ** 40), 2 ** 31],
                       [0, 2, 3, 5]),
    "one-1M-segment": _csr(3, 1_000_000, 1, lo=I64.min, hi=I64.max),
}


@pytest.mark.parametrize("name", sorted(PM_CASES))
def test_phase_max_matches_plain_and_numpy(cuda, name):
    vals, ptr = (np.asarray(a, np.int64) for a in PM_CASES[name])
    tv, tp = torch.from_numpy(vals).to(cuda), torch.from_numpy(ptr).to(cuda)
    before = pm.launches
    out = pm.phase_max(tv, tp)
    torch.cuda.synchronize()
    assert pm.launches == before + (1 if len(vals) and len(ptr) > 1 else 0)
    want = core.phase_worst_numpy(vals, ptr)
    assert out.dtype == torch.int64 and out.is_cuda
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    np.testing.assert_array_equal(pm.phase_max_plain(tv, tp).cpu().numpy(),
                                  want)
    np.testing.assert_array_equal(core.phase_worst_loads(vals, ptr), want)


def test_phase_max_refuses_what_it_does_not_take(cuda):
    v = torch.arange(4, device=cuda)
    p = torch.tensor([0, 2, 4], device=cuda)
    with pytest.raises(ValueError, match="int64"):
        pm.phase_max(v.int(), p)
    with pytest.raises(ValueError, match="contiguous"):
        pm.phase_max(torch.arange(8, device=cuda)[::2], p)
    with pytest.raises(ValueError, match="CUDA"):
        pm.phase_max(v, p.cpu())


@pytest.mark.parametrize("name", sorted(PM_CASES))
def test_phase_max_host_route_matches_plain_and_numpy(cuda, name):
    """The engines' route (page-locked [ptr | vals], the kernel reading it
    in place): bit-exact, one launch per call with work, int64 numpy out."""
    vals, ptr = (np.asarray(a, np.int64) for a in PM_CASES[name])
    before = pm.launches
    got = pm.phase_max_host(vals, ptr, cuda)
    assert pm.launches == before + (1 if len(vals) and len(ptr) > 1 else 0)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    want = core.phase_worst_numpy(vals, ptr)
    np.testing.assert_array_equal(got, want)
    plain = pm.phase_max_plain(torch.from_numpy(vals), torch.from_numpy(ptr))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_phase_max_host_route_grows_then_shrinks(cuda):
    """Calls of growing, then shrinking, size through the same staging
    buffers: every result bit-exact, none reads a larger call's leftovers;
    the buffers are page-locked and the kernel reaches them."""
    sizes = [(10, 3), (3345, 62), (22652, 398), (250_000, 4000),
             (43593, 753), (4758, 84), (7, 6), (1, 1), (0, 5)]
    for seed, (nvals, nseg) in enumerate(sizes + sizes[::-1]):
        vals, ptr = _csr(seed, nvals, nseg, lo=-(2 ** 40), hi=2 ** 40)
        np.testing.assert_array_equal(pm.phase_max_host(vals, ptr, cuda),
                                      core.phase_worst_numpy(vals, ptr))
    st = pm._staging[torch.cuda.current_device()]
    assert len(st.packed) >= 254_001 and len(st.out) >= 4000
    assert st.packed_at and st.out_at
    assert torch.from_numpy(st.packed).is_pinned()


def test_phase_max_host_route_allocates_nothing_per_call(cuda):
    """After warm-up, 100 calls leave the device's allocated memory where
    it was: no per-call tensor on the card."""
    vals, ptr = _csr(5, 23566, 444)
    pm.phase_max_host(vals, ptr, cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for i in range(100):
        v, p = _csr(i, 1000 + 200 * i, 20 + i)
        pm.phase_max_host(v, p, cuda)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


def test_phase_worst_loads_launches_once_per_solve(cuda):
    rng = np.random.default_rng(0)
    pm.launches = 0
    for i in range(25):
        vals, ptr = _csr(i, int(rng.integers(1, 30000)),
                         int(rng.integers(1, 500)))
        np.testing.assert_array_equal(core.phase_worst_loads(vals, ptr),
                                      core.phase_worst_numpy(vals, ptr))
        assert pm.launches == i + 1


@pytest.mark.parametrize("engine", ["v2", "batched"])
@pytest.mark.parametrize("strategy,golden", [("ecmp", 13417.8),
                                             ("sr", 3731.4),
                                             ("best", 2949.3)])
def test_simulate_on_cuda_matches_cpu(cuda, strategy, golden, engine):
    jobs = core.generate_trace(core.WorkloadSpec(
        num_jobs=200, mean_interarrival=120.0, seed=0, max_gpus=256))
    ref = core.simulate(core.CLUSTER512, jobs, strategy, engine=engine,
                        device="cpu")
    pm.launches = cs.solves = cb.solves = 0
    rep = core.simulate(core.CLUSTER512, jobs, strategy, engine=engine)
    assert pm.launches == cs.solves + cb.solves
    assert round(rep.avg_jct, 1) == pytest.approx(golden)
    assert rep.jcts == ref.jcts and rep.jwts == ref.jwts
    assert rep.slowdowns == ref.slowdowns


def test_run_lanes_on_cuda_matches_cpu(cuda):
    def lanes():
        return [(core.generate_trace(core.WorkloadSpec(
            num_jobs=150, mean_interarrival=load, seed=seed, max_gpus=64)),
            core.get_strategy(s), seed)
            for s in ("best", "sr", "ecmp") for seed in (0, 1)
            for load in (15.0, 60.0)]
    ref = core.run_lanes(core.CLUSTER2048, lanes(), device="cpu")
    pm.launches = cb.solves = 0
    reps = core.run_lanes(core.CLUSTER2048, lanes())
    assert cb.solves > 0 and pm.launches == cb.solves
    for a, b in zip(reps, ref):
        assert a.jcts == b.jcts and a.jwts == b.jwts
        assert a.slowdowns == b.slowdowns
        assert (a.frag_gpu, a.frag_network) == (b.frag_gpu, b.frag_network)


def _drop_wall(obj):
    if isinstance(obj, dict):
        return {k: _drop_wall(v) for k, v in obj.items()
                if k not in ("sim_seconds", "wall_time", "journal_seconds")}
    if isinstance(obj, list):
        return [_drop_wall(v) for v in obj]
    return obj


def test_campaign_on_cuda_matches_cpu(cuda):
    """A 6-cell campaign on cuda, serial and with 2 spawned workers, gives
    the cpu report; the serial run launches once per solve."""
    grid = core.CampaignGrid(strategies=("best", "sr", "ecmp"),
                             loads=(120.0,), seeds=(0, 1))
    wl = core.WorkloadSpec(num_jobs=60, max_gpus=64)
    ref = core.run_campaign(core.CLUSTER512, grid, workload=wl, device="cpu")
    pm.launches = cs.solves = cb.solves = 0
    ser = core.run_campaign(core.CLUSTER512, grid, workload=wl)
    assert cs.solves > 0 and pm.launches == cs.solves + cb.solves
    par = core.run_campaign(core.CLUSTER512, grid, workload=wl, workers=2)
    assert _drop_wall(ser.to_json()) == _drop_wall(ref.to_json())
    assert _drop_wall(par.to_json()) == _drop_wall(ref.to_json())


def test_smoke_figures_on_cuda_match_cpu(cuda):
    """The six smoke figures on cuda equal those on cpu, with one launch
    per solve."""
    from repro_torch.core.figures import build_all
    ref = build_all("smoke", device="cpu")
    pm.launches = cs.solves = cb.solves = 0
    tabs = build_all("smoke")
    assert cs.solves > 0 and pm.launches == cs.solves + cb.solves
    assert tabs == ref


def test_golden_replay_through_the_service_on_cuda(cuda):
    """The golden trace through the service loop on cuda: the pinned JCTs,
    the cpu service's placements and report, one launch per solve."""
    from repro_torch.service import LiveCluster, replay_trace

    def golden():
        return core.generate_trace(core.WorkloadSpec(
            num_jobs=200, mean_interarrival=120.0, seed=0, max_gpus=256))

    for strategy, jct in (("ecmp", 13417.8), ("sr", 3731.4)):
        cfg = core.SimConfig(strategy=strategy, engine="v2")
        ref = LiveCluster(core.CLUSTER512, cfg, device="cpu")
        rep_ref = replay_trace(ref, golden())
        pm.launches = cs.solves = 0
        live = LiveCluster(core.CLUSTER512, cfg)
        rep = replay_trace(live, golden())
        assert cs.solves > 0 and pm.launches == cs.solves
        assert round(rep.avg_jct, 1) == pytest.approx(jct)
        assert rep.to_journal() == rep_ref.to_journal()
        assert live.sim.placements == ref.sim.placements


def test_phase_worst_loads_from_two_threads_at_once(cuda):
    """Two threads, 200 calls each on distinct seeded CSR inputs, through
    the engines' route at the same time: every result bit-equal to the
    plain version, one launch per call (the staging is held per call)."""
    import threading
    cases = [[_csr(1000 * t + i, 200 + 97 * i, 1 + i % 120,
                   lo=-(2 ** 40), hi=2 ** 40) for i in range(200)]
             for t in range(2)]
    got = [[None] * 200 for _ in range(2)]
    start = threading.Barrier(2)

    def work(t):
        start.wait()
        for i, (vals, ptr) in enumerate(cases[t]):
            got[t][i] = core.phase_worst_loads(vals, ptr)

    pm.launches = 0
    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert pm.launches == 400
    for t in range(2):
        for (vals, ptr), out in zip(cases[t], got[t]):
            want = pm.phase_max_plain(torch.from_numpy(vals),
                                      torch.from_numpy(ptr)).numpy()
            np.testing.assert_array_equal(out, want)


def test_maxmin_torch_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    flows = [rng.choice(64, size=3, replace=False).tolist()
             for _ in range(512)]
    np.testing.assert_allclose(core.maxmin_fair_torch(flows),
                               core.maxmin_fair_torch(flows, device="cpu"),
                               atol=1e-6)
    np.testing.assert_allclose(core.maxmin_fair_torch(flows),
                               core.maxmin_fair_numpy(flows), atol=1e-6)


# ---------------------------------------------------------------------------
# RWKV6 chunked recurrence
# ---------------------------------------------------------------------------

def _rwkv_inputs(dev, b, h, t, dk, dv, seed=0, bonus=True):
    """q, k, v (normal), log decay in [log 0.3, 0], bonus, on ``dev``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k = (torch.randn(b, h, t, dk, generator=g) for _ in range(2))
    v = torch.randn(b, h, t, dv, generator=g)
    ld = torch.log(0.3 + 0.7 * torch.rand(b, h, t, dk, generator=g))
    u = torch.randn(h, dk, generator=g) * 0.2 if bonus else None
    return [None if x is None else x.to(dev) for x in (q, k, v, ld, u)]


RWKV_CASES = (   # (t, K, V, chunk)
    [(64, d, d, 16) for d in KV_DIMS]                  # every K = V
    + [(128, 64, 128, 16), (64, 128, 8, 8), (64, 8, 64, 4)]   # K != V
    + [(2048, 64, 64, 16)]                             # the serving path's T
    + [(96, 64, 64, c) for c in (1, 2, 4, 8, 32)]      # every chunk
    + [(128, 64, 64, 64), (12, 16, 16, 4), (7, 16, 16, 1)]
    + [(12, 16, 16, 12), (7, 16, 16, 7), (39, 64, 64, 13), (60, 32, 32, 3)])


def _check_rwkv(q, k, v, ld, u, chunk, s0=None, vb=None):
    """The fused kernel against its plain version on the same inputs: out
    within 1e-4 (float32) or one bf16 ulp (bf16), S within 1e-4.  Returns
    the launch plan."""
    before = kr.launches
    out, S = kr.rwkv6_fused(q, k, v, ld, bonus=u, chunk=chunk,
                            initial_state=s0, vb=vb)
    torch.cuda.synchronize()
    assert kr.launches == before + 1
    plan = kr.last_plan
    ref, ref_S = kr.rwkv6_fused_plain(q, k, v, ld, bonus=u, chunk=chunk,
                                      initial_state=s0)
    assert out.shape == ref.shape and out.dtype == q.dtype
    assert S.shape == ref_S.shape and S.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(S).all()
    if q.dtype != torch.float32:
        diff = (out.float() - ref.float()).abs()
        assert (diff <= ulp_bound(ref.float(), q.dtype)).all(), \
            diff.max().item()
    else:
        torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(S, ref_S, atol=F32_TOL, rtol=F32_TOL)
    return plan


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("t,dk,dv,chunk", RWKV_CASES,
                         ids=[f"t{t}-k{a}-v{b}-c{c}"
                              for t, a, b, c in RWKV_CASES])
def test_rwkv6_kernel_matches_plain(cuda, t, dk, dv, chunk, exclusive,
                                    with_state):
    """float32, from raw q / k / v / log decay; exclusive cases carry a
    bonus (the fused kernel's mask follows it)."""
    q, k, v, ld, u = _rwkv_inputs(cuda, 2, 3, t, dk, dv, seed=t + dk + dv,
                                  bonus=exclusive)
    s0 = (torch.randn(6, dk, dv, device=cuda) if with_state else None)
    _check_rwkv(q, k, v, ld, u, chunk, s0)


# chip_smoke.py's RWKV_CASES: name, (B, H, T, K, V), chunk, exclusive,
# initial state, decay
SMOKE_RWKV = [
    ("path", (4, 40, 2048, 64, 64), 16, True, False, "model"),
    ("path-s0", (4, 40, 2048, 64, 64), 16, True, True, "model"),
    ("reduced", (2, 4, 64, 16, 16), 16, True, False, "model"),
    ("k8-inclusive", (2, 4, 64, 8, 8), 16, False, False, "mild"),
    ("k32-c8", (2, 4, 64, 32, 32), 8, True, True, "model"),
    ("k128-c64", (2, 4, 256, 128, 128), 64, False, True, "mild"),
    ("mamba2-k64-v128", (2, 4, 256, 64, 128), 16, False, False, "model"),
    ("k128-v8-c2", (1, 4, 64, 128, 8), 2, True, False, "model"),
    ("k8-v128-c32", (1, 4, 64, 8, 128), 32, False, False, "mild"),
    ("k64-c64-excl", (2, 4, 128, 64, 64), 64, True, False, "mild"),
    ("t12-c12", (2, 4, 12, 64, 64), 12, True, True, "model"),
    ("t7-c7", (2, 4, 7, 16, 16), 7, True, True, "model"),
    ("t17-c1", (2, 4, 17, 16, 16), 1, True, True, "model"),
]


def _smoke_inputs(dev, shape, excl, decay, dtype, seed):
    b, h, t, dk, dv = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k = (torch.randn(b, h, t, dk, generator=g) for _ in range(2))
    v = torch.randn(b, h, t, dv, generator=g)
    if decay == "model":
        ld = -torch.exp(torch.randn(b, h, t, dk, generator=g) - 0.5)
    else:
        ld = torch.log(0.3 + 0.7 * torch.rand(b, h, t, dk, generator=g))
    u = torch.randn(h, dk, generator=g) * 0.1 if excl else None
    return ([x.to(dev, dtype) for x in (q, k, v, ld)]
            + [None if u is None else u.to(dev)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SMOKE_RWKV, ids=[c[0] for c in SMOKE_RWKV])
def test_rwkv6_fused_matches_plain_at_smoke_shapes(cuda, case, dtype):
    name, shape, chunk, excl, with_s0, decay = case
    q, k, v, ld, u = _smoke_inputs(cuda, shape, excl, decay, dtype, seed=7)
    s0 = (torch.randn(shape[0] * shape[1], shape[3], shape[4], device=cuda)
          if with_s0 else None)
    _check_rwkv(q, k, v, ld, u, chunk, s0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
def test_rwkv6_reads_split_heads_views_without_copies(cuda, with_state,
                                                      dtype):
    """The model's ``split_heads`` views of (B, T, H·D) tensors go to the
    kernel as they are: besides out and S, the call allocates no more than
    the bonus and state copies (a copy of q alone would be 5 MB here)."""
    b, t, h, d = 2, 512, 40, 64
    g = torch.Generator(device="cpu").manual_seed(3)
    flat = [torch.randn(b, t, h * d, generator=g).to(cuda, dtype)
            for _ in range(4)]
    flat[3] = -torch.exp(flat[3].float() - 0.5).to(dtype)
    q, k, v, ld = (x.view(b, t, h, d).transpose(1, 2) for x in flat)
    assert not q.is_contiguous()
    u = torch.randn(h, d, device=cuda) * 0.1
    s0 = torch.randn(b * h, d, d, device=cuda) if with_state else None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, S = kr.rwkv6_fused(q, k, v, ld, bonus=u, chunk=16,
                            initial_state=s0)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert kr.last_plan["loads"] == "ring"
    assert extra <= out.numel() * out.element_size() + S.numel() * 4 + 4096
    # out is a view of a (B, T, H, V) tensor: the model's reshape is free
    y = out.transpose(1, 2)
    assert y.is_contiguous() and y.reshape(b, t, h * d).data_ptr() \
        == y.data_ptr()
    _check_rwkv(q, k, v, ld, u, 16, s0)


@pytest.mark.parametrize("loads", ["ring", "direct"])
@pytest.mark.parametrize("vb", kr.VB_CHOICES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv6_every_vb_and_load_path(cuda, vb, loads, dtype):
    """Every column block the plan can choose, through the cp.async ring
    and through direct loads (rows off 16 bytes: a view one element in)."""
    q, k, v, ld, u = _smoke_inputs(cuda, (2, 3, 96, 65, 65), True, "model",
                                   dtype, seed=vb)
    q, k, v, ld = (x[..., 1:] for x in (q, k, v, ld))     # K = V = 64
    u = u[:, 1:]
    if loads == "ring":
        q, k, v, ld = (x.contiguous() for x in (q, k, v, ld))
    plan = _check_rwkv(q, k, v, ld, u, 16, vb=vb)
    assert plan["vb"] == vb and plan["loads"] == loads


def test_rwkv6_direct_loads_when_the_ring_does_not_fit(cuda):
    q, k, v, ld, u = _smoke_inputs(cuda, (1, 2, 128, 128, 128), False,
                                   "mild", torch.float32, seed=1)
    assert _check_rwkv(q, k, v, ld, u, 64)["loads"] == "direct"


def test_rwkv6_plan_picks_vb_threads_and_loads(cuda):
    """The plan: VB 32, 128 threads and the ring on the serving path's
    layout; VB V when V is narrower; VB 64 with 256 threads when asked; K
    128 at chunk 64 in float32 reads directly (its ring would not fit) and
    takes VB 64 only in sub-blocks of 32 rows; K 256 cannot take VB 64 at
    any sub-block."""
    q, k, v, ld, u = _smoke_inputs(cuda, (2, 3, 32, 64, 64), True, "model",
                                   torch.bfloat16, seed=4)
    plan = _check_rwkv(q, k, v, ld, u, 16)
    assert (plan["vb"], plan["threads"], plan["loads"]) == (32, 128, "ring")
    assert _check_rwkv(q, k, v, ld, u, 16, vb=32) == plan
    assert _check_rwkv(q, k, v, ld, u, 16, vb=64)["threads"] == 256
    for d in (8, 16):
        q, k, v, ld, u = _smoke_inputs(cuda, (1, 2, 32, d, d), True, "model",
                                       torch.float32, seed=d)
        assert _check_rwkv(q, k, v, ld, u, 16)["vb"] == d
    q, k, v, ld, u = _smoke_inputs(cuda, (1, 2, 128, 128, 128), False,
                                   "mild", torch.float32, seed=5)
    assert _check_rwkv(q, k, v, ld, u, 64)["vb"] == 32
    assert _check_rwkv(q, k, v, ld, u, 64, vb=64)["cs"] == 32
    q, k, v, ld, u = _smoke_inputs(cuda, (1, 2, 128, 256, 64), False,
                                   "mild", torch.float32, seed=5)
    before = kr.launches
    with pytest.raises(ValueError, match="shared memory"):
        kr.rwkv6_fused(q, k, v, ld, chunk=64, vb=64)
    assert kr.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [1, 7, 64, 100])
@pytest.mark.parametrize("dk", PLAN_DIMS)
@pytest.mark.parametrize("dv", PLAN_DIMS)
def test_rwkv6_every_default_plan_fits_and_runs(cuda, dv, dk, chunk, dtype):
    """Every K, V, chunk and dtype the wrapper takes gets a plan that fits
    in shared memory (VB narrowed, or the chunk cut in sub-blocks, where
    needed) and agrees with the plain version."""
    q, k, v, ld, u = _smoke_inputs(cuda, (1, 2, 2 * chunk, dk, dv), True,
                                   "model", dtype, seed=dk + dv + chunk)
    plan = _check_rwkv(q, k, v, ld, u, chunk)
    assert plan["smem"] <= 232448 and plan["vb"] <= 32
    assert plan["vb"] <= max(8, 1 << (dv - 1).bit_length())
    assert plan["cs"] <= min(chunk, kr.MAX_SUB)


def test_rwkv6_ring_ignores_the_stride_of_a_size_one_dim(cuda):
    """A batch of one whose batch stride is not a multiple of 16 bytes still
    has every row aligned: the plan takes the ring and the kernel runs."""
    b, h, t, d = 1, 4, 64, 64
    q, k, v, ld, u = _smoke_inputs(cuda, (b, h, t, d, d), True, "model",
                                   torch.bfloat16, seed=6)

    def odd_batch_stride(x):
        buf = torch.empty(h * t * d + 16, dtype=x.dtype, device=cuda)
        y = buf.as_strided((b, h, t, d), (h * t * d + 3, t * d, d, 1))
        y.copy_(x)
        return y
    q, k, v, ld = (odd_batch_stride(x) for x in (q, k, v, ld))
    assert (q.stride(0) * q.element_size()) % 16
    assert _check_rwkv(q, k, v, ld, u, 16)["loads"] == "ring"


def test_rwkv6_dispatch_sends_cuda_tensors_to_the_kernel(cuda):
    q, k, v, ld, u = _rwkv_inputs(cuda, 1, 2, 32, 16, 16)
    before = kr.launches
    out = ops.rwkv6_mix(q, k, v, ld, bonus=u, chunk=16)
    assert kr.launches == before + 1 and out.is_cuda
    ref = ops.rwkv6_mix(*(x.cpu() for x in (q, k, v, ld)), bonus=u.cpu(),
                        chunk=16)
    torch.testing.assert_close(out.cpu(), ref, atol=F32_TOL, rtol=F32_TOL)


def test_rwkv6_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, ld, u = _rwkv_inputs(cuda, 1, 2, 32, 16, 16)
    before = kr.launches
    with pytest.raises(ValueError, match="inner stride"):
        kr.rwkv6_fused(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                       ld, chunk=16)
    with pytest.raises(ValueError, match="bf16 or float32"):
        kr.rwkv6_fused(*(x.double() for x in (q, k, v, ld)), chunk=16)
    with pytest.raises(ValueError, match="one dtype"):
        kr.rwkv6_fused(q, k.to(torch.bfloat16), v, ld, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        kr.rwkv6_fused(q, k[:, :, :16], v, ld, chunk=16)
    with pytest.raises(ValueError, match="K=257"):
        wide = torch.zeros(1, 2, 32, 257, device=cuda)
        kr.rwkv6_fused(wide, wide, v, wide, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        kr.rwkv6_fused(q, k, v, ld, chunk=128)
    with pytest.raises(ValueError, match="initial_state"):
        kr.rwkv6_fused(q, k, v, ld, chunk=16,
                       initial_state=torch.zeros(2, 16, 8, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        kr.rwkv6_fused(q, k, v, ld.cpu(), chunk=16)
    with pytest.raises(ValueError, match="vb"):
        kr.rwkv6_fused(q, k, v, ld, chunk=16, vb=12)
    assert kr.launches == before


# ---------------------------------------------------------------------------
# coverage: every K, V, chunk and dtype the recurrence kernel takes
# ---------------------------------------------------------------------------

# (T, K, V, chunk): the CPU coverage tests' shapes, K / V off powers of two,
# odd and at the ends of the range, chunks above 64 in sub-blocks (ragged
# ones too) and a chunk of the whole sequence
COVER_RWKV = [(256, 24, 40, 128), (256, 256, 16, 256), (256, 64, 128, 128),
              (256, 100, 36, 32), (200, 7, 1, 100), (130, 256, 256, 65),
              (96, 1, 7, 96), (2048, 64, 64, 2048)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("exclusive", [True, False],
                         ids=["bonus", "inclusive"])
@pytest.mark.parametrize("t,dk,dv,chunk", COVER_RWKV,
                         ids=[f"t{t}-k{a}-v{b}-c{c}"
                              for t, a, b, c in COVER_RWKV])
def test_coverage_rwkv6_kernel_matches_plain(cuda, t, dk, dv, chunk,
                                             exclusive, with_state, dtype):
    """The fused kernel against its plain version over the coverage
    shapes, in every dtype: float32 within 1e-4, 16-bit within one ulp of
    the output, final S within 1e-4.  The chunk of the whole sequence
    (2048) runs on decays a tenth as steep, so that its exponentials stay
    in float32's range, as the reference's would not otherwise."""
    q, k, v, ld, u = _rwkv_inputs(cuda, 1, 2, t, dk, dv, seed=t + dk + dv,
                                  bonus=exclusive)
    if chunk > 256:
        ld = ld * 0.1
    q, k, v, ld = (x.to(dtype) for x in (q, k, v, ld))
    s0 = torch.randn(2, dk, dv, device=cuda) if with_state else None
    plan = _check_rwkv(q, k, v, ld, u, chunk, s0)
    assert plan["chunk"] == chunk and plan["cs"] <= min(chunk, kr.MAX_SUB)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dk,dv,chunk", [(24, 40, 128), (100, 36, 32),
                                         (64, 128, 128)])
def test_coverage_rwkv6_split_heads_views(cuda, dk, dv, chunk, dtype):
    """The model's ``split_heads`` views of (B, T, H·D) tensors at the new
    shapes (rows off 16 bytes where H·D is, then direct loads)."""
    b, t, h = 2, 256, 4
    g = torch.Generator(device="cpu").manual_seed(dk + dv)
    flat = [torch.randn(b, t, h * d, generator=g).to(cuda, dtype)
            for d in (dk, dk, dv, dk)]
    flat[3] = torch.log(0.3 + 0.7 * torch.rand(b, t, h * dk, generator=g)
                        ).to(cuda, dtype)
    q, k, v, ld = (x.view(b, t, h, -1).transpose(1, 2) for x in flat)
    assert not q.is_contiguous()
    u = torch.randn(h, dk, device=cuda) * 0.1
    _check_rwkv(q, k, v, ld, u, chunk)


def test_rwkv6_cuda_prefill_never_precomputes_inputs(cuda, monkeypatch):
    """On the card the kernel reads the model's tensors: the float32
    precompute of the plain version is never called."""
    def refuse(*a, **kw):
        raise AssertionError("rwkv6_inputs called on the CUDA path")
    monkeypatch.setattr(kr, "rwkv6_inputs", refuse)
    cfg = configs.reduced(configs.get_config("rwkv6-3b"), num_layers=2)
    lm = LM.init(cfg, seed=1, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda)
    kr.launches = 0
    with torch.inference_mode():
        logits, _ = prefill(lm.compute_params(), cfg, toks, max_len=56)
        full = forward(lm.compute_params(), cfg, toks)[0]
    torch.cuda.synchronize()
    assert kr.launches == 2 * cfg.num_layers
    assert torch.isfinite(logits.float()).all()
    assert torch.isfinite(full.float()).all()


@pytest.mark.parametrize("s", [40, 12, 7],
                         ids=["chunk-8", "chunk-12", "chunk-7"])
def test_rwkv6_prefill_launches_once_per_layer_and_matches_cpu(cuda, s):
    cfg = configs.reduced(configs.get_config("rwkv6-3b"), dtype="float32",
                          num_layers=3)
    lm_cpu = LM.init(cfg, seed=2, device="cpu")
    lm_gpu = LM(cfg, lm_cpu.params).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, s)))
    kr.launches = fa.launches = 0
    with torch.inference_mode():
        logits, state = prefill(lm_gpu.compute_params(), cfg, toks.to(cuda),
                                max_len=s + 8)
        torch.cuda.synchronize()
        assert kr.launches == cfg.num_layers and fa.launches == 0
        ref, ref_state = prefill(lm_cpu.compute_params(), cfg, toks,
                                 max_len=s + 8)
    torch.testing.assert_close(logits.cpu(), ref, atol=F32_TOL, rtol=F32_TOL)
    for name in ("rwkv_S", "tmix_last", "cmix_last"):
        torch.testing.assert_close(state[name].cpu(), ref_state[name],
                                   atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# training: the autograd Functions around the kernels, on the card
# ---------------------------------------------------------------------------

def _grads(fn, ins, weights):
    ins = [None if x is None else x.detach().clone().requires_grad_()
           for x in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    loss.backward()
    return [o.detach() for o in outs], [None if x is None else x.grad
                                        for x in ins]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,hd,window", [(256, 64, None), (256, 32, None),
                                         (300, 64, 48), (1000, 128, None)])
def test_attention_function_grads_on_the_card(cuda, s, hd, window, dtype):
    """The Function launches the kernel once forward and recomputes the
    backward through ``blocked_attention``: its grads equal autograd
    through ``blocked_attention`` alone (float32 1e-4; bf16 one bf16 ulp of
    the reference grad, 8e-3 where |g| < 2)."""
    from repro_torch.models.attention import blocked_attention
    q, k, v = _qkv(cuda, 2, s, 8, 2, hd, dtype, seed=s + hd)
    w = torch.randn(q.shape, device=cuda)
    before = fa.launches
    (out,), got = _grads(lambda *x: ops.attention(*x, window=window),
                         (q, k, v), (w,))
    assert fa.launches == before + 1
    _, want = _grads(lambda *x: blocked_attention(*x, window=window),
                     (q, k, v), (w,))
    assert fa.launches == before + 1      # the recompute launches nothing
    for g, r in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        if dtype == torch.bfloat16:
            err = (g.float() - r.float()).abs()
            assert bool((err <= bf16_bound(r.float())).all()), err.max()
        else:
            torch.testing.assert_close(g, r, atol=F32_TOL, rtol=F32_TOL)
    ref = fa.flash_attention_plain(q, k, v, True, window)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("exclusive", [True, False],
                         ids=["bonus", "inclusive"])
def test_rwkv6_function_grads_on_the_card(cuda, exclusive, with_state):
    """Forward through the fused kernel, backward through the chunk scan:
    output 1e-4 of the plain version, grads 1e-4 of autograd through the
    scan alone, at B·H 8, T 256, K = V = 64."""
    from repro_torch.models.ssm import chunked_linear_attention_scan
    q, k, v, ld, u = _rwkv_inputs(cuda, 2, 4, 256, 64, 64)
    u = u if exclusive else None
    s0 = (torch.randn(2, 4, 64, 64, device=cuda) if with_state else None)
    ws = (torch.randn(2, 4, 256, 64, device=cuda),
          torch.randn(2, 4, 64, 64, device=cuda))
    before = kr.launches
    (out, S), got = _grads(lambda *x: ops.rwkv6_mix_state(
        *x[:4], bonus=x[4], chunk=16, initial_state=x[5]),
        (q, k, v, ld, u, s0), ws)
    assert kr.launches == before + 1
    (rout, rS), want = _grads(lambda *x: chunked_linear_attention_scan(
        *x[:4], bonus=x[4], chunk=16, initial_state=x[5]),
        (q, k, v, ld, u, s0), ws)
    torch.testing.assert_close(out, rout, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(S, rS, atol=F32_TOL, rtol=F32_TOL)
    for g, r in zip(got, want):
        if r is not None:
            torch.testing.assert_close(g, r, atol=F32_TOL, rtol=F32_TOL)


def test_kernel_wrappers_refuse_grad_on_the_card(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(q.requires_grad_(), k, v)
    rq, rk, rv, ld, u = _rwkv_inputs(cuda, 1, 2, 32, 16, 16)
    with pytest.raises(RuntimeError, match="requires grad"):
        kr.rwkv6_fused(rq, rk, rv, ld.requires_grad_(), bonus=u, chunk=16)


@pytest.mark.parametrize("arch,remat", [("tinyllama-1.1b", "none"),
                                        ("tinyllama-1.1b", "full"),
                                        ("rwkv6-3b", "dots")])
def test_loss_and_grads_on_cuda_match_cpu(cuda, arch, remat):
    """Reduced float32 through ``loss_and_grads`` on the card (the kernel
    forward) and on the CPU (the plain versions): loss 1e-5, grads 1e-4;
    the kernel runs once per layer, twice under remat."""
    from repro_torch.models.context import ModelContext
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.tree import flatten
    cfg = configs.reduced(configs.get_config(arch), dtype="float32",
                          num_layers=2)
    cpu_params = init_lm(cfg, 0, device="cpu")
    gpu_params = _to(cpu_params, cuda)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 65)))
    ctx = ModelContext(remat=remat)
    mod = kr if cfg.family == "ssm" else fa
    mod.launches = 0
    loss, grads = loss_and_grads(cfg, gpu_params, toks[:, :-1].to(cuda),
                                 toks[:, 1:].to(cuda), ctx=ctx)
    torch.cuda.synchronize()
    assert mod.launches == cfg.num_layers * (1 if remat == "none" else 2)
    ref_loss, ref = loss_and_grads(cfg, cpu_params, toks[:, :-1],
                                   toks[:, 1:], ctx=ctx)
    assert abs(loss.item() - ref_loss.item()) <= 1e-5
    for (path, g), (_, r) in zip(flatten(grads), flatten(ref)):
        torch.testing.assert_close(g.cpu(), r, atol=F32_TOL, rtol=F32_TOL,
                                   msg=path)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.detach().to(dev)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the moe family on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,factor", [("deepseek-moe-16b", 1.25),
                                         ("deepseek-moe-16b", 0.5),
                                         ("mixtral-8x22b", 1.25)])
def test_moe_apply_dense_on_cuda_matches_cpu(cuda, arch, factor):
    """Float32 (no TF32): the same routing decisions (indices, slots, keep;
    the inputs have no near-tie at the k-th choice) and outputs within
    1e-4; factor 0.5 drops pairs."""
    from repro_torch.models import moe as TM
    cfg = configs.reduced(configs.get_config(arch), dtype="float32",
                          moe_num_experts=16, moe_top_k=4,
                          moe_capacity_factor=factor)
    params = TM.moe_init(torch.Generator().manual_seed(0), cfg.d_model,
                      cfg.moe_num_experts, cfg.moe_d_ff,
                      cfg.moe_shared_experts)
    params["router"] *= 4.0          # spread the choices
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    x_flat = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(x_flat @ params["router"], dim=-1)
    top = probs.topk(cfg.moe_top_k + 1, dim=-1).values
    assert bool((top[:, -2] - top[:, -1] > 1e-5).all())
    cap = TM._capacity(x_flat.shape[0], cfg.moe_top_k, cfg.moe_num_experts,
                       factor)
    want = TM._route(params["router"], x_flat, cfg.moe_top_k,
                     cfg.moe_num_experts, cap)
    got = TM._route(params["router"].to(cuda), x_flat.to(cuda),
                    cfg.moe_top_k, cfg.moe_num_experts, cap)
    for i in (0, 2, 3):
        assert torch.equal(got[i].cpu(), want[i])
    if factor < 1:
        assert not bool(want[3].all())
    y, aux = TM.moe_apply_dense(_to(params, cuda), x.to(cuda), cfg)
    ref, ref_aux = TM.moe_apply_dense(params, x, cfg)
    torch.testing.assert_close(y.cpu(), ref, atol=F32_TOL, rtol=F32_TOL)
    assert abs(aux.item() - ref_aux.item()) <= 1e-6


@pytest.mark.parametrize("b,s", [(4, 2048), (1, 300)])
def test_kernel_at_the_deepseek_shape(cuda, b, s):
    """deepseek-moe-16b's prefill attention: MHA 16 / 16, head_dim 128,
    bf16, causal: the wgmma variant, one bf16 ulp of its plain version."""
    _check(*_qkv(cuda, b, s, 16, 16, 128, torch.bfloat16), "wgmma_tma")


def test_moe_generate_launches_attention_once_per_layer(cuda):
    """Reduced deepseek-moe-16b (a dense layer, then MoE layers) with bf16
    weights through ``generate``: one attention launch per layer in
    prefill, none in decode; float32 compute matches the CPU at 1e-4."""
    from repro_torch.launch.serve import generate
    cfg = configs.reduced(configs.get_config("deepseek-moe-16b"),
                          dtype="float32", num_layers=3)
    lm_cpu = LM.init(cfg, seed=2, device="cpu", dtype=torch.bfloat16)
    lm_gpu = LM(cfg, lm_cpu.params).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    fa.launches = kr.launches = pm.launches = 0
    res = generate(lm_gpu, toks.to(cuda), 1)
    torch.cuda.synchronize()
    assert fa.launches == cfg.num_layers
    fa.launches = 0
    res = generate(lm_gpu, toks.to(cuda), 6)
    torch.cuda.synchronize()
    assert fa.launches == cfg.num_layers and kr.launches == pm.launches == 0
    ref = generate(lm_cpu, toks, 6)
    assert torch.equal(res.tokens.cpu(), ref.tokens)
    torch.testing.assert_close(res.last_logits.cpu(), ref.last_logits,
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# the hybrid family: attention at head_dim 80, the recurrence as Mamba2
# calls it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s", [(4, 2048), (1, 300)])
def test_kernel_at_the_zamba2_shape(cuda, b, s, dtype):
    """zamba2-2.7b's shared attention: MHA 32 / 32, head_dim 80, causal:
    the wgmma kernel in bf16, the FMA kernel in float32."""
    variant = "wgmma_tma" if dtype == torch.bfloat16 else "mma_fma"
    _check(*_qkv(cuda, b, s, 32, 32, 80, dtype, seed=s), variant)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 127, 129, 300])
@pytest.mark.parametrize("hq,hkv,window", [(8, 2, None), (4, 4, 48),
                                           (8, 1, 200)],
                         ids=["gqa4", "window48", "mqa-window200"])
def test_kernel_hd80_groups_windows_and_edges(cuda, hq, hkv, window, s,
                                              dtype):
    _check(*_qkv(cuda, 2, s, hq, hkv, 80, dtype, seed=s + hq), window=window)


def _mamba2_operands(dev, b, h, t, dk, dv, seed=0):
    """The recurrence's operands as ``mamba2_apply`` builds them: float32
    q = C broadcast over the heads (head stride 0), k = B·dt (B,H,T,K), v
    the (B,H,T,hd) view of a (B,T,H·hd) tensor, and the scalar log decay
    dt·A made contiguous over K."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    c, bb = (torch.randn(b, t, dk, generator=g).to(dev) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=g)
                                      ).to(dev)
    a = -torch.exp(torch.randn(h, generator=g) * 0.5).to(dev)
    xi = torch.randn(b, t, h * dv, generator=g).to(dev)
    q = c[:, None].expand(b, h, t, dk)
    k = bb[:, None] * dt.transpose(1, 2)[..., None]
    v = xi.view(b, t, h, dv).transpose(1, 2)
    ld = (dt * a).transpose(1, 2)[..., None].expand(b, h, t, dk).contiguous()
    return q, k, v, ld


@pytest.mark.parametrize("b,t", [(4, 2048), (2, 256)])
def test_rwkv6_mamba2_call_matches_plain(cuda, b, t):
    """The served path's call: inclusive mask, no bonus, float32, B·H 160
    (40 heads), K 64, V 128, chunk 16, from the head-broadcast views; out
    and final S within 1e-4 of the plain version, read in place (the ring
    takes the zero head stride)."""
    q, k, v, ld = _mamba2_operands(cuda, b, 40, t, 64, 128, seed=t)
    assert q.stride(1) == 0 and not v.is_contiguous()
    plan = _check_rwkv(q, k, v, ld, None, 16)
    assert plan["loads"] == "ring"


def test_hybrid_generate_launches_each_kernel_per_block(cuda):
    """Reduced zamba2 (4 Mamba2 blocks, the shared block every 2) in
    float32 through ``generate``: the recurrence once per Mamba2 block and
    attention once per application point in prefill, neither in decode;
    tokens equal and logits within 1e-4 of the CPU's."""
    from repro_torch.launch.serve import generate
    cfg = configs.reduced(configs.get_config("zamba2-2.7b"), dtype="float32",
                          num_layers=4)
    lm_cpu = LM.init(cfg, seed=2, device="cpu")
    lm_gpu = LM(cfg, lm_cpu.params).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    fa.launches = kr.launches = pm.launches = 0
    res = generate(lm_gpu, toks.to(cuda), 6)
    torch.cuda.synchronize()
    assert kr.launches == cfg.num_layers
    assert fa.launches == cfg.num_layers // cfg.attn_every
    assert pm.launches == 0
    ref = generate(lm_cpu, toks, 6)
    assert torch.equal(res.tokens.cpu(), ref.tokens)
    torch.testing.assert_close(res.last_logits.cpu(), ref.last_logits,
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# the audio family: non-causal attention with Sq != Skv (whisper's encoder
# and cross attention)
# ---------------------------------------------------------------------------

SQ_SKV = [(224, 1500), (1500, 224), (1, 1500), (129, 63), (300, 1)]


@pytest.mark.parametrize("dtype,hd,variant", [
    (torch.bfloat16, 64, "wgmma_tma"), (torch.bfloat16, 128, "wgmma_tma"),
    (torch.bfloat16, 80, "wgmma_tma"), (torch.float32, 64, "mma_fma"),
    (torch.bfloat16, 96, "wgmma_tma"), (torch.bfloat16, 192, "wgmma_tma"),
    (torch.float32, 96, "mma_fma"), (torch.float32, 192, "mma_fma")],
    ids=["bf16-hd64", "bf16-hd128", "bf16-hd80", "f32-hd64", "bf16-hd96",
         "bf16-hd192", "f32-hd96", "f32-hd192"])
@pytest.mark.parametrize("sq,skv", SQ_SKV,
                         ids=[f"{a}x{b}" for a, b in SQ_SKV])
def test_kernel_non_causal_sq_ne_skv(cuda, sq, skv, dtype, hd, variant):
    """Ragged tiles on both sides (1500 = 23 x 64 + 28 keys, 224 = 1.75 of
    the wgmma kernel's 128 rows), a single q row, a single key, fewer keys
    than one tile, and q rows of the second consumer warpgroup that all lie
    past Sq."""
    _check(*_qkv(cuda, 2, sq, 4, 4, hd, dtype, seed=sq + skv, skv=skv),
           variant, causal=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("sq,skv", [(224, 1500), (129, 63)])
def test_kernel_non_causal_sq_ne_skv_gqa(cuda, sq, skv, hd, dtype):
    _check(*_qkv(cuda, 2, sq, 8, 2, hd, dtype, seed=hd, skv=skv),
           causal=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,sq,skv,causal", [
    ("encoder", 1500, 1500, False), ("cross", 224, 1500, False),
    ("decoder", 224, 224, True)])
def test_kernel_at_the_whisper_shapes(cuda, name, sq, skv, causal, dtype):
    """whisper-base served at B 16: 8 / 8 heads of 64; the encoder over
    1500 frames, the cross attention of a 224-token prompt to them and the
    decoder's causal self-attention (bf16: the wgmma kernel)."""
    variant = "wgmma_tma" if dtype == torch.bfloat16 else "mma_fma"
    _check(*_qkv(cuda, 16, sq, 8, 8, 64, dtype, seed=sq, skv=skv), variant,
           causal=causal)


def test_kernel_reads_cross_cache_views(cuda):
    """The cross K/V as prefill hands them over: rows [:n] of the
    (B, max_len, Hkv, hd) cache, so the batch stride spans max_len rows."""
    kc, vc = (torch.randn(2, 1536, 8, 64, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn(2, 224, 8, 64, device=cuda).to(torch.bfloat16)
    k, v = kc[:, :1500], vc[:, :1500]
    assert not k.is_contiguous()
    _check(q, k, v, "wgmma_tma", causal=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,skv,hd", [(224, 1500, 64), (129, 63, 64),
                                       (300, 100, 80)])
def test_attention_function_grads_at_sq_ne_skv(cuda, sq, skv, hd, dtype):
    """Cross attention through the Function: one launch forward, grads
    equal autograd through ``blocked_attention`` (float32 1e-4; bf16 one
    bf16 ulp of the reference grad, 8e-3 where |g| < 2)."""
    from repro_torch.models.attention import blocked_attention
    q, k, v = _qkv(cuda, 2, sq, 8, 2, hd, dtype, seed=sq, skv=skv)
    w = torch.randn(q.shape, device=cuda)
    before = fa.launches
    _, got = _grads(lambda *x: ops.attention(*x, causal=False), (q, k, v),
                    (w,))
    assert fa.launches == before + 1
    _, want = _grads(lambda *x: blocked_attention(*x, causal=False),
                     (q, k, v), (w,))
    for g, r in zip(got, want):
        assert g.shape == r.shape and torch.isfinite(g.float()).all()
        if dtype == torch.bfloat16:
            err = (g.float() - r.float()).abs()
            assert bool((err <= bf16_bound(r.float())).all()), err.max()
        else:
            torch.testing.assert_close(g, r, atol=F32_TOL, rtol=F32_TOL)


def test_audio_generate_launches_attention_three_times_per_layer(cuda):
    """Reduced whisper (2 encoder + 2 decoder layers) in float32 through
    ``generate`` with 20 float32 frames: attention once per encoder layer
    and twice per decoder layer (self, cross) in prefill, never in decode;
    tokens equal and logits within 1e-4 of the CPU's."""
    from repro_torch.launch.serve import generate
    cfg = configs.reduced(configs.get_config("whisper-base"),
                          dtype="float32")
    lm_cpu = LM.init(cfg, seed=2, device="cpu")
    lm_gpu = LM(cfg, lm_cpu.params).to(cuda)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
    frames = torch.as_tensor(rng.normal(size=(2, 20, cfg.d_model)),
                             dtype=torch.float32)
    fa.launches = kr.launches = pm.launches = 0
    res = generate(lm_gpu, toks.to(cuda), 6, frames.to(cuda))
    torch.cuda.synchronize()
    assert fa.launches == cfg.encoder_layers + 2 * cfg.num_layers
    assert kr.launches == pm.launches == 0
    ref = generate(lm_cpu, toks, 6, frames)
    assert torch.equal(res.tokens.cpu(), ref.tokens)
    torch.testing.assert_close(res.last_logits.cpu(), ref.last_logits,
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# the vlm family: attention at head_dim 96 (phi-3-vision) and 192
# (nemotron-4-340b) on the wgmma kernel (bf16) and the FMA kernel (float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s", [(4, 2048), (1, 300)])
def test_kernel_at_the_phi3_shape(cuda, b, s, dtype):
    """phi-3-vision-4.2b's attention: MHA 32 / 32, head_dim 96, causal."""
    variant = "wgmma_tma" if dtype == torch.bfloat16 else "mma_fma"
    _check(*_qkv(cuda, b, s, 32, 32, 96, dtype, seed=s), variant)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [2048, 300])
def test_kernel_at_the_nemotron_head_shape(cuda, s, dtype):
    """nemotron-4-340b's attention heads: 96 / 8 (GQA 12) of 192, causal."""
    variant = "wgmma_tma" if dtype == torch.bfloat16 else "mma_fma"
    _check(*_qkv(cuda, 1, s, 96, 8, 192, dtype, seed=s), variant)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [96, 192])
@pytest.mark.parametrize("s", [1, 127, 129, 300])
@pytest.mark.parametrize("hq,hkv,window", [(8, 2, None), (4, 4, 48),
                                           (8, 1, 200)],
                         ids=["gqa4", "window48", "mqa-window200"])
def test_kernel_hd96_hd192_groups_windows_and_edges(cuda, hq, hkv, window,
                                                    s, hd, dtype):
    _check(*_qkv(cuda, 2, s, hq, hkv, hd, dtype, seed=s + hq + hd),
           window=window)


# The wgmma kernel's head dims that are not a multiple of 64 or need a
# three-stage ring: (label, (B, Sq, Hq, Hkv[, Skv]), causal, window, fused)
WGMMA_NEW_CASES = [
    ("s1", (2, 1, 8, 2), True, None, False),
    ("s63", (2, 63, 8, 2), True, None, False),
    ("s127", (2, 127, 8, 2), True, None, False),
    ("s129", (2, 129, 8, 2), True, None, False),
    ("s1000", (2, 1000, 8, 2), True, None, False),
    ("b1-mqa-s333", (1, 333, 16, 1), True, None, False),
    ("b1-gqa8-s257", (1, 257, 16, 2), True, None, False),
    ("window1", (1, 1000, 4, 4), True, 1, False),
    ("window48", (1, 1000, 4, 4), True, 48, False),
    ("window200", (1, 300, 8, 2), True, 200, False),
    ("nc-window200", (1, 300, 4, 2), False, 200, False),
    ("nc-224x1500", (2, 224, 8, 2, 1500), False, None, False),
    ("nc-1500x224", (2, 1500, 8, 2, 224), False, None, False),
    ("nc-1x1500", (2, 1, 8, 2, 1500), False, None, False),
    ("nc-129x63", (2, 129, 8, 2, 63), False, None, False),
    ("nc-300x1", (2, 300, 8, 2, 1), False, None, False),
    ("fused", (2, 257, 8, 2), True, None, True),
    ("fused-window100", (2, 257, 8, 2), True, 100, True),
    ("fused-nc", (2, 200, 4, 4), False, None, True),
]


@pytest.mark.parametrize("case", WGMMA_NEW_CASES, ids=[c[0] for c in
                                                       WGMMA_NEW_CASES])
@pytest.mark.parametrize("hd", [80, 96, 192])
def test_wgmma_kernel_at_hd_80_96_192(cuda, hd, case):
    """bf16 at head_dim 80 and 96 (a second 64-column box that TMA fills
    in part, the PV product at n80 / n96) and 192 (three boxes, a 3-stage
    ring, the PV product at n192 completed before S is issued): ragged Sq /
    Skv off the 64-key and 128-row tiles, B = 1, S = 1, GQA groups 1 / 4 /
    8 / 16, windows across tile edges, non-causal with Sq != Skv, and views
    of a fused qkv projection; one bf16 ulp of the plain version."""
    _, shape, causal, window, fused = case
    b, sq, hq, hkv = shape[:4]
    if fused:
        g = torch.Generator(device="cpu").manual_seed(hd + sq)
        x = torch.randn(b, sq, (hq + 2 * hkv) * hd, generator=g).to(
            cuda, torch.bfloat16).view(b, sq, hq + 2 * hkv, hd)
        q, k, v = x[:, :, :hq], x[:, :, hq:hq + hkv], x[:, :, hq + hkv:]
    else:
        q, k, v = _qkv(cuda, b, sq, hq, hkv, hd, torch.bfloat16,
                       seed=hd + sq, skv=shape[4] if len(shape) > 4 else None)
    _check(q, k, v, "wgmma_tma", causal=causal, window=window)


@pytest.mark.parametrize("dtype,hd,nbytes", [
    (torch.bfloat16, 96, 164968), (torch.bfloat16, 192, 197712),
    (torch.float32, 96, 94208), (torch.float32, 192, 167936)])
def test_smem_bytes_at_hd96_and_hd192(cuda, dtype, hd, nbytes):
    """bf16, the wgmma kernel's Plan: 1 KB of alignment, Q (two 64-column
    boxes of 128 rows at hd 96, three at 192) and a ring of K and V tiles
    (4 stages of two 64 x 64 boxes each; 3 stages of three at 192), then
    the mbarriers.  float32, the FMA kernel's: K, V and Q (64 x (hd + 4))
    and four warps' 16 x 68 P rows.  All above the 48 KB default, which
    the launch opts into."""
    assert fa.smem_bytes(dtype, hd) == nbytes
    assert fa.built_variant(dtype, hd) == (
        "wgmma_tma" if dtype == torch.bfloat16 else "mma_fma")


def test_vlm_forward_with_patches_launches_once_per_layer(cuda):
    """Reduced phi-3-vision at head_dim 96 (4 heads), float32, with 16
    patch embeddings: ``forward`` on the card launches attention once per
    layer and matches the plain path on the CPU at 1e-4."""
    cfg = configs.reduced(configs.get_config("phi-3-vision-4.2b"),
                          dtype="float32", head_dim=96)
    lm_cpu = LM.init(cfg, seed=2, device="cpu")
    lm_gpu = LM(cfg, lm_cpu.params).to(cuda)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)))
    pe = torch.as_tensor(rng.normal(size=(2, cfg.num_patches, cfg.d_model)),
                         dtype=torch.float32)
    fa.launches = kr.launches = pm.launches = 0
    with torch.inference_mode():
        out = lm_gpu(toks.to(cuda), patch_embeds=pe.to(cuda))
        torch.cuda.synchronize()
        assert fa.launches == cfg.num_layers
        assert kr.launches == pm.launches == 0
        ref = lm_cpu(toks, patch_embeds=pe)
    torch.testing.assert_close(out.cpu(), ref, atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# the kernel boundary under a mesh: ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

TP_ATTENTION_CASES = [  # (B, S, Hq, Hkv, hd) on 2 ranks
    (4, 2048, 32, 4, 64),     # tinyllama at TP 2: 16 / 2 local heads
    (2, 512, 8, 1, 64),       # one KV head on 2 ranks: K / V made whole
]


def _tp_attention_rank(rank, world, case):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import distribute_local
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    b, s, hq, hkv, hd = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, s, h, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    full = fa.flash_attention(q, k, v)
    mesh = make_smoke_mesh((world,), ("a",), device="cuda")
    kv_pl = [Shard(2)] if hkv % world == 0 else [Replicate()]
    fa.launches = 0
    out = ops.attention(distribute_local(q, mesh, [Shard(2)]),
                        distribute_local(k, mesh, kv_pl),
                        distribute_local(v, mesh, kv_pl))
    torch.cuda.synchronize()
    local = out.to_local()
    n = hq // world
    want = full[:, :, rank * n:(rank + 1) * n]
    return {"within": bool(((local.float() - want.float()).abs()
                            <= bf16_bound(want.float())).all()),
            "bit_exact": bool(torch.equal(local, want)),
            "launches": fa.launches, "shape": fa.last_shape}


@pytest.mark.parametrize("case", TP_ATTENTION_CASES,
                         ids=["tinyllama-tp2", "kv-fewer-than-tp"])
def test_attention_under_local_map_matches_unsharded(cuda, case, tmp_path):
    """Each rank's kernel on its local heads (ops.attention on DTensors,
    through local_map) against the unsharded kernel's output for the same
    heads: within one bf16 ulp, bit-exactness printed."""
    from repro_torch.testing import run_ranks
    out = run_ranks(_tp_attention_rank, 2, (case,), workdir=tmp_path,
                    timeout=300)
    b, s, hq, hkv, hd = case
    for r in out:
        print(f"attention under local_map {case}: bit-exact "
              f"{r['bit_exact']}, local shape {r['shape']}")
        assert r["within"] and r["launches"] == 1
        assert tuple(r["shape"]) == (b, s, hq // 2, max(hkv // 2, 1), hd)


# (dtype, mask): RWKV6's exclusive mask with the bonus at rwkv6-3b's head
# shape, Mamba2's inclusive one with q broadcast over the heads at
# zamba2's (K 64, V 128)
RWKV_MESH_CASES = [(dt, mask) for dt in ("float32", "bfloat16")
                   for mask in ("rwkv6", "mamba2")]


def _rwkv_mesh_rank(rank, world, dtype, mask):
    """The recurrence on a (1, 1) NCCL mesh (``ops.rwkv6_mix_state`` on
    DTensors, through ``_sharded_rwkv6_mix`` and ``local_map``) and with
    no mesh, on the same tensors."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import compute_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, t, dk = 2, 8, 256, 64
    dv = 64 if mask == "rwkv6" else 128

    def normal(*size):
        return torch.randn(size, generator=gen, device=dev)
    k, v = normal(b, h, t, dk).to(dt), normal(b, h, t, dv).to(dt)
    if mask == "rwkv6":
        q = normal(b, h, t, dk).to(dt)
        ld = (-torch.exp(normal(b, h, t, dk) - 1.0)).to(dt)
        bonus = normal(h, dk) * 0.1
    else:
        q = normal(b, 1, t, dk).to(dt).expand(b, h, t, dk)
        ld = (-torch.exp(normal(b, h, t, 1) - 1.0)).expand(
            b, h, t, dk).contiguous().to(dt)
        bonus = None
    kr.launches = 0
    want, want_s = ops.rwkv6_mix_state(q, k, v, ld, bonus=bonus, chunk=16)
    mesh = compute_mesh(make_smoke_mesh((1, 1), device="cuda"))

    def place(x):
        return None if x is None else DTensor.from_local(
            x, mesh, [Replicate()], run_check=False)
    out, S = ops.rwkv6_mix_state(place(q), place(k), place(v), place(ld),
                                 bonus=place(bonus), chunk=16)
    torch.cuda.synchronize()
    return {"out_equal": torch.equal(out.to_local(), want),
            "state_equal": torch.equal(S.to_local(), want_s),
            "launches": kr.launches, "shape": kr.last_shape}


@pytest.mark.parametrize("dtype,mask", RWKV_MESH_CASES,
                         ids=[f"{d}-{m}" for d, m in RWKV_MESH_CASES])
def test_recurrence_on_a_one_rank_mesh_equals_no_mesh(cuda, dtype, mask,
                                                      tmp_path):
    """The recurrence through ``_sharded_rwkv6_mix`` on a (1, 1) NCCL mesh
    equals the call with no mesh, output and final state, in float32 and
    bf16, with both masks: one launch each, at the whole shape."""
    from repro_torch.testing import run_ranks
    r = run_ranks(_rwkv_mesh_rank, 1, (dtype, mask), workdir=tmp_path,
                  timeout=300, backend="nccl")[0]
    assert r["out_equal"] and r["state_equal"]
    assert r["launches"] == 2
    assert tuple(r["shape"]) == (2, 8, 256, 64, 64 if mask == "rwkv6"
                                 else 128)


def _a2a_rank(rank, world):
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    x = torch.arange(world * 3, device=dev, dtype=torch.float32) + 100 * rank
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    want = torch.cat([torch.arange(rank * 3, rank * 3 + 3, device=dev,
                                   dtype=torch.float32) + 100 * j
                      for j in range(world)])
    return bool(torch.equal(out, want))


def test_gloo_all_to_all_single_on_cuda_tensors(cuda, tmp_path):
    from repro_torch.testing import run_ranks
    assert run_ranks(_a2a_rank, 2, workdir=tmp_path, timeout=120) == [True,
                                                                       True]


def _gloo_dtensor_rank(rank, world):
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.testing import gloo_cuda
    gloo_cuda.use_c10d_collectives()
    torch.cuda.set_device(0)
    mesh = make_smoke_mesh((world,), ("a",), device="cuda")
    x = torch.arange(8.0, device="cuda")
    gathered = distribute_tensor(x, mesh, [Shard(0)]).redistribute(
        mesh, [Replicate()]).to_local()
    part = DTensor.from_local(torch.full((8,), rank + 1.0, device="cuda"),
                              mesh, [Partial()])
    scattered = part.redistribute(mesh, [Shard(0)]).to_local()
    m = torch.arange(16.0, device="cuda").reshape(4, 4)
    moved = distribute_tensor(m, mesh, [Shard(0)]).redistribute(
        mesh, [Shard(1)]).full_tensor()
    return (torch.equal(gathered, x),
            bool((scattered == world * (world + 1) / 2).all()),
            torch.equal(moved, m))


def test_dtensor_redistribute_under_gloo_on_cuda(cuda, tmp_path):
    """DTensor's all-gather, reduce-scatter and all-to-all redistributions
    on CUDA tensors under gloo, through ``testing.gloo_cuda``: each against
    its plain expectation."""
    from repro_torch.testing import run_ranks
    assert run_ranks(_gloo_dtensor_rank, 2, workdir=tmp_path,
                     timeout=120) == [(True, True, True)] * 2


# ---------------------------------------------------------------------------
# RunConfig's chunk 128 and serving under a mesh (ROADMAP 6c, 6d)
# ---------------------------------------------------------------------------

def _fault1_case(cuda, shape, exclusive, dtype, seed):
    """``ops.rwkv6_mix_state`` at chunk 128 on ``shape`` (B, H, T, K, V)
    with an initial state: the kernel launches once at 128 (``last_plan``),
    forward and final S match the plain version at 128, and the grads of q,
    k, v, log decay, bonus and S0 (the Function's backward, the chunk scan
    at 128) match autograd through ``chunked_linear_attention_scan`` at 128
    alone.  float32 1e-4; bf16 output within one bf16 ulp (grads in
    float32 only)."""
    from repro_torch.models.ssm import chunked_linear_attention_scan
    b, h, t, dk, dv = shape
    q, k, v, ld, u = _rwkv_inputs(cuda, b, h, t, dk, dv, seed=seed,
                                  bonus=exclusive)
    q, k, v, ld = (x.to(dtype) for x in (q, k, v, ld))
    s0 = torch.randn(b, h, dk, dv, device=cuda)
    ins = (q, k, v, ld, u, s0)
    before = kr.launches
    if dtype != torch.float32:
        out, S = ops.rwkv6_mix_state(q, k, v, ld, bonus=u, chunk=128,
                                     initial_state=s0)
        torch.cuda.synchronize()
        assert kr.launches == before + 1 and kr.last_plan["chunk"] == 128
        ref, ref_S = kr.rwkv6_fused_plain(q, k, v, ld, bonus=u, chunk=128,
                                          initial_state=s0)
        diff = (out.float() - ref.float()).abs()
        assert (diff <= bf16_bound(ref.float())).all(), diff.max().item()
        torch.testing.assert_close(S, ref_S, atol=F32_TOL, rtol=F32_TOL)
        return
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    ws = (torch.randn(b, h, t, dv, generator=g).to(cuda),
          torch.randn(b, h, dk, dv, generator=g).to(cuda))
    (out, S), got = _grads(lambda *x: ops.rwkv6_mix_state(
        *x[:4], bonus=x[4], chunk=128, initial_state=x[5]), ins, ws)
    torch.cuda.synchronize()
    assert kr.launches == before + 1 and kr.last_plan["chunk"] == 128
    (rout, rS), want = _grads(lambda *x: chunked_linear_attention_scan(
        *x[:4], bonus=x[4], chunk=128, initial_state=x[5]), ins, ws)
    assert kr.launches == before + 1      # the recompute launches nothing
    torch.testing.assert_close(out, rout, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(S, rS, atol=F32_TOL, rtol=F32_TOL)
    for gr, r in zip(got, want):
        if r is not None:
            assert torch.isfinite(gr).all()
            torch.testing.assert_close(gr, r, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("exclusive", [True, False],
                         ids=["rwkv6", "inclusive"])
def test_rwkv6_kernel_at_run_config_chunk(cuda, exclusive, dtype):
    """Fault 1's test: the recurrence at ``RunConfig``'s chunk 128 runs its
    forward and its backward at 128, as the reference does (the kernel
    once ran 64 and the backward recomputed at 128)."""
    _fault1_case(cuda, (2, 4, 512, 64, 64), exclusive, dtype, 128)


def test_rwkv6_run_config_chunk_at_zamba2_shape(cuda):
    """Fault 1's test at zamba2-2.7b's full-width Mamba2 call (B 4, 40
    heads, T 2048, K 64, V 128, inclusive, float32)."""
    _fault1_case(cuda, (4, 40, 2048, 64, 128), False, torch.float32, 2048)


def test_rwkv6_chunk_128_on_rwkv6_3b_decays(cuda):
    """Recorded, not gated: on rwkv6-3b's full-width random decays
    (-exp(N(-0.5, 1)), clamped at -4 a step) the reference's own chunk-128
    exponentials leave float32's range; whether the kernel's and the plain
    version's outputs are finite is printed."""
    shape = (4, 40, 2048, 64, 64)
    q, k, v, ld, u = _smoke_inputs(cuda, shape, True, "model",
                                   torch.bfloat16, seed=3)
    out, S = kr.rwkv6_fused(q, k, v, ld, bonus=u, chunk=128)
    ref, ref_S = kr.rwkv6_fused_plain(q, k, v, ld, bonus=u, chunk=128)
    torch.cuda.synchronize()
    print(f"rwkv6-3b decays at chunk 128: kernel output finite "
          f"{bool(torch.isfinite(out.float()).all())}, S finite "
          f"{bool(torch.isfinite(S).all())}; plain output finite "
          f"{bool(torch.isfinite(ref.float()).all())}, S finite "
          f"{bool(torch.isfinite(ref_S).all())}; plan {kr.last_plan}")


RUN_CONFIG_ARCHS = {"rwkv6-3b": {}, "zamba2-2.7b": {"num_layers": 4}}


def _run_config_rank(rank, world, arch):
    """An ssm / hybrid forward through ``make_context`` on a (1, 1) NCCL
    mesh with ``RunConfig()`` (chunk 128) against no mesh at chunk 128."""
    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.context import ModelContext
    from repro_torch.models.transformer import init_lm
    from repro_torch.bridge import place_params
    from repro_torch.parallel.sharding import distribute_local, make_context
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = reduced(get_config(arch), dtype="float32",
                  **RUN_CONFIG_ARCHS[arch])
    params = init_lm(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                         device=dev)
    with torch.no_grad():
        kr.launches = 0
        want, _ = forward(params, cfg, toks, ctx=ModelContext(ssm_chunk=128))
        plain_launches, plain_chunk = kr.launches, kr.last_plan["chunk"]
        ctx = make_context(make_smoke_mesh((1, 1), device="cuda"), cfg,
                           RunConfig())
        kr.launches = 0
        got, _ = forward(place_params(params, cfg, ctx.mesh), cfg,
                         distribute_local(toks, ctx.dmesh,
                                          ctx.placements("dp", None)),
                         ctx=ctx)
        got = got.full_tensor()
    torch.cuda.synchronize()
    return {"chunk": ctx.ssm_chunk, "launches": (plain_launches, kr.launches),
            "launched_chunk": (plain_chunk, kr.last_plan["chunk"]),
            "err": (got - want).abs().max().item(),
            "bit_exact": torch.equal(got, want), "layers": cfg.num_layers}


@pytest.mark.parametrize("arch", list(RUN_CONFIG_ARCHS))
def test_run_config_chunk_on_a_one_rank_mesh(cuda, arch, tmp_path):
    """``make_context(mesh, cfg, RunConfig())`` keeps chunk 128; the
    forward runs the recurrence kernel once a layer at chunk 128, with no
    fallback, and equals the forward with no mesh at chunk 128 (within
    1e-6, bit-exactness printed)."""
    from repro_torch.testing import run_ranks
    r = run_ranks(_run_config_rank, 1, (arch,), workdir=tmp_path,
                  timeout=300, backend="nccl")[0]
    print(f"{arch} RunConfig() on a (1, 1) mesh: max |diff| {r['err']:.3e},"
          f" bit-exact {r['bit_exact']}")
    assert r["chunk"] == 128
    assert r["launches"] == (r["layers"], r["layers"])
    assert r["launched_chunk"] == (128, 128)
    assert r["err"] <= 1e-6


SERVE_MESH_ARCHS = {"tinyllama-1.1b": {}, "whisper-base": {},
                    "tinyllama-swa": {"sliding_window": 8},
                    "rwkv6-3b": {}, "zamba2-2.7b": {"num_layers": 4}}


def _serve_mesh_rank(rank, world, name, dtype):
    """Prefill and 3 greedy decode steps on a (1, 1) NCCL mesh (the decode
    state in ``decode_state_specs``' layout, the sequence-split decode
    attention and cache writes, ``greedy``) and with no mesh."""
    from repro_torch.bridge import place_params
    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.parallel.sharding import make_context
    from repro_torch.serve.decode import decode_step, greedy
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    arch = "tinyllama-1.1b" if name == "tinyllama-swa" else name
    cfg = reduced(get_config(arch), dtype=dtype, **SERVE_MESH_ARCHS[name])
    params = init_lm(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                         device=dev)
    frames = (torch.randn((2, 40, cfg.d_model), generator=gen, device=dev)
              if cfg.is_encoder_decoder else None)
    ctx = make_context(make_smoke_mesh((1, 1), device="cuda"), cfg,
                       RunConfig())

    def serve(p, c):
        outs, caches = [], []
        with torch.no_grad():
            lg, st = prefill(p, cfg, toks, 48, ctx=c, frame_embeds=frames)
            for _ in range(4):
                outs.append(lg.full_tensor() if c.mesh is not None else lg)
                lg, st = decode_step(p, cfg, greedy(lg, c), st, ctx=c)
        for n, t in st.items():
            if isinstance(t, torch.Tensor):
                caches.append(t.full_tensor() if c.mesh is not None else t)
        return outs, caches

    from repro_torch.models.context import ModelContext
    want, want_state = serve(params, ModelContext(ssm_chunk=ctx.ssm_chunk))
    got, got_state = serve(place_params(params, cfg, ctx.mesh), ctx)
    torch.cuda.synchronize()
    return {"logits_equal": all(torch.equal(a, b) for a, b in
                                zip(got, want)),
            "state_equal": all(torch.equal(a, b) for a, b in
                               zip(got_state, want_state)),
            "err": max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, want))}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(SERVE_MESH_ARCHS))
def test_serving_on_a_one_rank_mesh_equals_no_mesh(cuda, name, dtype,
                                                   tmp_path):
    """Prefill into the mesh's decode state and 3 decode steps on a (1, 1)
    NCCL mesh equal no mesh bit for bit: every logit and every tensor of
    the decode state (the caches' writes, rolling ones included, the
    recurrent states, whisper's cross caches)."""
    from repro_torch.testing import run_ranks
    r = run_ranks(_serve_mesh_rank, 1, (name, dtype), workdir=tmp_path,
                  timeout=300, backend="nccl")[0]
    assert r["logits_equal"] and r["state_equal"], r["err"]


ONE_RANK_ATTENTION = {  # (B, Sq, Skv, Hq, Hkv, hd, causal)
    "whisper-cross": (4, 224, 1500, 8, 8, 64, False),
    "phi3-hd96": (2, 512, 512, 32, 32, 96, True)}


def _one_rank_attention(rank, world, case):
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import distribute_local, make_context
    from repro_torch.configs import get_config
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    b, sq, skv, hq, hkv, hd, causal = case
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((b, sq, hq, hd), generator=gen, device=dev)
    k, v = (torch.randn((b, skv, hkv, hd), generator=gen, device=dev)
            for _ in range(2))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    want = fa.flash_attention(q, k, v, causal=causal)
    ctx = make_context(make_smoke_mesh((1, 1), device="cuda"),
                       get_config("tinyllama-1.1b"))
    pl = ctx.placements("dp", None, "tp", None)
    fa.launches = 0
    out = ops.attention(*(distribute_local(x, ctx.dmesh, pl)
                          for x in (q, k, v)), causal=causal)
    torch.cuda.synchronize()
    return {"equal": torch.equal(out.to_local(), want),
            "launches": fa.launches, "shape": fa.last_shape}


@pytest.mark.parametrize("name", list(ONE_RANK_ATTENTION))
def test_sharded_attention_on_a_one_rank_mesh(cuda, name, tmp_path):
    """``_sharded_attention`` on a (1, 1) NCCL mesh at whisper's cross
    shape (non-causal, Sq 224 != Skv 1500) and phi-3's head_dim 96 equals
    the unsharded kernel bit for bit, in one launch at the whole shape."""
    from repro_torch.testing import run_ranks
    case = ONE_RANK_ATTENTION[name]
    r = run_ranks(_one_rank_attention, 1, (case,), workdir=tmp_path,
                  timeout=300, backend="nccl")[0]
    b, sq, skv, hq, hkv, hd, _ = case
    assert r["equal"] and r["launches"] == 1
    assert tuple(r["shape"]) == (b, sq, hq, hkv, hd)


# ---------------------------------------------------------------------------
# the kernels as registered ops; the dry run's counts on the card
# ---------------------------------------------------------------------------

OPCHECK_ATTENTION = [  # (B, Sq, Skv, Hq, Hkv, hd, dtype, causal, window)
    (2, 300, 300, 8, 2, 64, torch.bfloat16, True, None),
    (2, 129, 129, 8, 8, 80, torch.bfloat16, True, 48),
    (2, 224, 1500, 4, 4, 64, torch.bfloat16, False, None),
    (1, 127, 127, 8, 2, 96, torch.float32, True, None),
]


@pytest.mark.parametrize("case", OPCHECK_ATTENTION,
                         ids=lambda c: f"{c[1]}x{c[2]}-hd{c[5]}-"
                                       f"{str(c[6]).split('.')[-1]}")
def test_attention_op_passes_opcheck_on_card(cuda, case):
    """``repro_torch::flash_attention_fwd`` on CUDA tensors: the schema,
    the fake kernel against the kernel's output (shape, dtype, strides) and
    the op through AOT dispatch; its output is the wrapper's."""
    b, sq, skv, hq, hkv, hd, dtype, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((b, sq, hq, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, skv, hkv, hd), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    torch.library.opcheck(ops.flash_attention_op, (q, k, v, causal, window))
    fa.launches = 0
    got = ops.flash_attention_op(q, k, v, causal, window)
    assert fa.launches == 1
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal,
                                               window=window))


OPCHECK_RECURRENCE = [  # (B, H, T, K, V, dtype, bonus, state, chunk)
    (2, 4, 128, 64, 64, torch.bfloat16, True, False, 16),
    (1, 4, 96, 64, 128, torch.float32, False, True, 16),
    (1, 2, 64, 32, 32, torch.float32, True, True, 64),
]


@pytest.mark.parametrize("case", OPCHECK_RECURRENCE,
                         ids=lambda c: f"K{c[3]}-V{c[4]}-"
                                       f"{str(c[5]).split('.')[-1]}")
def test_recurrence_op_passes_opcheck_on_card(cuda, case):
    """``repro_torch::rwkv6_fused_fwd`` on CUDA tensors: opcheck, and the
    op's output is the wrapper's, in the kernel's (B, T, H, V) layout."""
    b, h, t, dk, dv, dtype, bonus, state, chunk = case
    gen = torch.Generator(device=cuda).manual_seed(6)

    def normal(*size):
        return torch.randn(size, generator=gen, device=cuda)
    q, k = (normal(b, h, t, dk).to(dtype) for _ in range(2))
    v = normal(b, h, t, dv).to(dtype)
    ld = (-torch.rand((b, h, t, dk), generator=gen, device=cuda)).to(dtype)
    u = normal(h, dk) if bonus else None
    s0 = normal(b, h, dk, dv) if state else None
    torch.library.opcheck(ops.rwkv6_fused_op, (q, k, v, ld, u, s0, chunk))
    kr.launches = 0
    out, s = ops.rwkv6_fused_op(q, k, v, ld, u, s0, chunk)
    assert kr.launches == 1
    want, want_s = kr.rwkv6_fused(q, k, v, ld, bonus=u, chunk=chunk,
                                  initial_state=s0)
    assert torch.equal(out, want) and torch.equal(s, want_s)
    assert out.stride() == want.stride()


def test_recorder_counts_the_kernels_on_card(cuda):
    """The dry run's recorder around a real CUDA forward of reduced
    tinyllama: one attention op call a layer at its FLOP formula, and as
    many launches; the same forward on fake cuda tensors counts the same
    FLOPs with no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import Recorder
    from repro_torch.models.transformer import init_lm
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"),
                          num_heads=4, num_kv_heads=2, d_model=256,
                          head_dim=64, d_ff=512, vocab_size=512)
    params = init_lm(cfg, 0, device=cuda)
    toks = torch.randint(0, 512, (2, 128), device=cuda)
    fa.launches = 0
    real = Recorder(device_type="cuda")
    with real, torch.no_grad():
        forward(params, cfg, toks)
    assert fa.launches == cfg.num_layers
    assert real.op_calls == {"flash_attention_fwd": cfg.num_layers}
    fa.launches = 0
    with FakeTensorMode(allow_non_fake_inputs=True):
        fparams = init_lm(cfg, 0, device="meta")
        fparams = {k: v for k, v in fparams.items()}
        from repro_torch.train.tree import tree_map
        fparams = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                 device="cuda"), fparams)
        ftoks = torch.zeros((2, 128), dtype=torch.long, device="cuda")
        fake = Recorder(device_type="cuda")
        with fake, torch.no_grad():
            forward(fparams, cfg, ftoks)
    assert fa.launches == 0
    assert fake.flops == real.flops and fake.op_calls == real.op_calls


# ---------------------------------------------------------------------------
# the local head counts that whole heads under an uneven split hand the
# kernels (the production mesh's model axis of 16 over 8, 40 or 40 SSM
# heads; tests/test_torch_distributed_heads.py holds the mesh path on the
# CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,hd", [(3, 1, 64), (5, 5, 128), (1, 1, 64),
                                       (2, 2, 80)],
                         ids=["gqa3-1", "qwen5-5", "whisper1-1",
                              "zamba2-2-2"])
def test_attention_function_grads_at_local_heads(cuda, hq, hkv, hd, dtype):
    """``_FlashAttention`` at the local heads a rank takes where the tp
    split does not divide the heads (6 / 2 heads on a split of 2;
    qwen1.5-32b's 40 on "a" 8; whisper-base's 8 on "a" 8; zamba2's shared
    block, 32 on 16): one launch, the output against the plain version and
    the grads against autograd through ``blocked_attention``, at the gates
    of ``test_attention_function_grads_on_the_card``."""
    from repro_torch.models.attention import blocked_attention
    q, k, v = _qkv(cuda, 2, 256, hq, hkv, hd, dtype, seed=hq * hd)
    w = torch.randn(q.shape, device=cuda)
    before = fa.launches
    (out,), got = _grads(lambda *x: ops.attention(*x), (q, k, v), (w,))
    assert fa.launches == before + 1
    _, want = _grads(lambda *x: blocked_attention(*x), (q, k, v), (w,))
    ref = fa.flash_attention_plain(q, k, v, True, None)
    pairs = list(zip(got, want)) + [(out, ref)]
    for g, r in pairs:
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        if dtype == torch.bfloat16:
            err = (g.float() - r.float()).abs()
            assert bool((err <= bf16_bound(r.float())).all()), err.max()
        else:
            torch.testing.assert_close(g, r, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("h,dv,exclusive", [(5, 64, True), (40, 128, False),
                                            (1, 64, True)],
                         ids=["rwkv6-5", "zamba2-40", "rwkv6-1"])
def test_rwkv6_function_grads_at_local_heads(cuda, h, dv, exclusive):
    """``_Rwkv6Mix`` at the local heads a rank takes: rwkv6-3b's 40 heads on
    "a" 8 (5, the bonus), zamba2's 40 SSM heads whole on a split of 16
    that does not divide them (40, inclusive, V 128), one head: output
    and final state 1e-4 of the plain version, grads 1e-4 of autograd
    through the chunk scan."""
    from repro_torch.models.ssm import chunked_linear_attention_scan
    q, k, v, ld, u = _rwkv_inputs(cuda, 2, h, 128, 64, dv, seed=h)
    u = u if exclusive else None
    ws = (torch.randn(2, h, 128, dv, device=cuda),
          torch.randn(2, h, 64, dv, device=cuda))
    before = kr.launches
    (out, S), got = _grads(lambda *x: ops.rwkv6_mix_state(
        *x[:4], bonus=x[4], chunk=16), (q, k, v, ld, u), ws)
    assert kr.launches == before + 1
    (rout, rS), want = _grads(lambda *x: chunked_linear_attention_scan(
        *x[:4], bonus=x[4], chunk=16), (q, k, v, ld, u), ws)
    plain, plain_S = kr.rwkv6_fused_plain(q, k, v, ld, bonus=u, chunk=16)
    for a, b in ((out, rout), (S, rS), (out, plain), (S, plain_S)):
        torch.testing.assert_close(a.float(), b.float(), atol=F32_TOL,
                                   rtol=F32_TOL)
    for g, r in zip(got, want):
        if r is not None:
            torch.testing.assert_close(g, r, atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# the port's examples on the card
# ---------------------------------------------------------------------------

def _example(name, *argv):
    import os
    import subprocess
    import sys
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, str(root / "examples" / name),
                        *argv], env={**os.environ,
                                     "PYTHONPATH": str(root / "src")},
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_quickstart_example_launches_layers_times_steps(cuda):
    import re
    out = _example("quickstart_torch.py", "--device", "cuda")
    m = re.search(r"attention kernel launches: (\d+) \((\d+) layers x "
                  r"(\d+) steps on cuda\)", out)
    assert m and int(m.group(1)) == int(m.group(2)) * int(m.group(3)) == 10
    losses = [float(x) for x in re.findall(r"step \d: loss (\S+)", out)]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_multi_tenant_example_launches_once_a_solve(cuda):
    import re
    out = _example("multi_tenant_cluster_torch.py", "--jobs", "12",
                   "--device", "cuda")
    m = re.search(r"segment-max kernel launches: (\d+) of (\d+) solves on "
                  r"cuda", out)
    assert m and int(m.group(1)) == int(m.group(2)) > 0


def test_rwkv6_batch_of_one_decode_cell_on_the_production_mesh(cuda):
    """rwkv6-3b's long_500k cell (a decode step at a batch of one, which
    does not split over dp) on 16 x 16 fake ranks with cuda fake tensors,
    at full depth, where FSDP splits the stacked ``decay_base`` (32 x 2560
    values) over "data": the low-rank decay's product is a partial sum over
    "data" there (``w_decay_b``'s rows split by FSDP), which the card's
    DTensor could not add to the split ``decay_base``; the sum is reduced
    first (``models/ssm.py::_sum_partials``)."""
    from repro_torch.launch import dryrun
    r = dryrun.lower_cell("rwkv6-3b", "long_500k", False,
                          {"skip_aux": True}, device="cuda")
    assert r["status"] == "ok" and r["chips"] == 256
