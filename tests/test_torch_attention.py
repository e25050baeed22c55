"""Port vs reference: attention.

The port's ``kernels.ops.attention`` on CPU tensors runs the Hopper kernel's
plain version; it is held against the reference's Pallas kernel
(``attention(implementation="pallas")``, interpret mode on the CPU) on the
shapes and masks of ``tests/test_kernels.py``, with its tolerances: float32
2e-5, bf16 2e-2.  ``decode_attention`` is held against the reference's at
float32 2e-5.

Non-causal attention with Sq != Skv (whisper's cross attention) is held
against the Pallas kernel the same way, forward and grads.

Training: the port's ``blocked_attention`` (the backward's recompute)
against the reference's, forward 2e-5 (bf16 2e-2) and grads 1e-4; the
autograd Function around the kernel passes ``gradcheck`` in float64 and its
grads match ``jax.grad`` through the reference's ``custom_vjp`` at 1e-4;
the kernel's wrapper refuses inputs that require grad.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ops import attention as jax_attention  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, s, hq, hkv, hd, dtype, skv=None):
    """Same values for both frameworks: numpy normals rounded to `dtype`;
    k / v have ``skv`` rows (default ``s``)."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for n, h in ((s, hq), (skv or s, hkv), (skv or s, hkv)):
        x = jnp.asarray(rng.normal(size=(b, n, h, hd)), jdt)
        out.append((x, torch.from_numpy(np.array(x, np.float32)).to(tdt)))
    return out


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,hd", [
    (2, 128, 4, 4, 32),     # MHA
    (1, 256, 8, 2, 64),     # GQA
    (2, 96, 4, 1, 16),      # MQA, ragged seq
    (1, 160, 4, 4, 80),     # zamba2's head_dim, MHA
    (2, 100, 4, 2, 80),     # head_dim 80, GQA, ragged seq
    (1, 160, 4, 4, 96),     # phi-3-vision's head_dim, MHA
    (2, 100, 8, 2, 192),    # nemotron-4-340b's head_dim, GQA, ragged seq
])
def test_attention_matches_pallas(b, s, hq, hkv, hd, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(s + hq, b, s, hq, hkv, hd, dtype)
    ref = jax_attention(jq, jk, jv, implementation="pallas",
                        block_q=64, block_k=64)
    out = ops.attention(tq, tk, tv)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref, DTYPES[dtype][2])


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)])
def test_attention_masks_match_pallas(causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(0, 1, 160, 2, 2, 32, "float32")
    ref = jax_attention(jq, jk, jv, causal=causal, window=window,
                        implementation="pallas", block_q=32, block_k=32)
    out = ops.attention(tq, tk, tv, causal=causal, window=window)
    _close(out, ref, 2e-5)


SQ_SKV = [(12, 40), (40, 12), (1, 33), (17, 5), (33, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", SQ_SKV,
                         ids=[f"{a}x{b}" for a, b in SQ_SKV])
def test_cross_attention_matches_pallas(sq, skv, dtype):
    """Non-causal with Sq != Skv (whisper's cross attention): ragged q and
    k tiles, a single q row, a single key."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(sq + skv, 2, sq, 4, 2, 16, dtype,
                                           skv=skv)
    ref = jax_attention(jq, jk, jv, causal=False, implementation="pallas",
                        block_q=16, block_k=16)
    out = ops.attention(tq, tk, tv, causal=False)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref, DTYPES[dtype][2])


def _bf16_ulp_bound(ref):
    """One bf16 ulp of |ref|, at least 8e-3 (the ulp below 2)."""
    mag = np.maximum(np.abs(ref), 1e-30)
    return np.maximum(8e-3, 2.0 ** (np.floor(np.log2(mag)) - 7))


@pytest.mark.parametrize("b,s,hq,hkv,hd,window", [
    (2, 128, 4, 4, 32, None),
    (1, 256, 8, 2, 64, None),
    (2, 96, 4, 1, 16, None),
    (1, 320, 4, 2, 64, 48),
    (1, 160, 4, 4, 80, None),
])
def test_bf16_attention_follows_the_pallas_path(b, s, hq, hkv, hd, window):
    """Of the reference's two bf16 paths, the port follows the Pallas
    kernel, which keeps P in float32, and not ``blocked_attention``, which
    rounds P to bf16 (attention.py:94): in bf16 the two agree to the
    output's own rounding, one bf16 ulp (8e-3 where |o| < 2)."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(s + hd, b, s, hq, hkv, hd,
                                           "bfloat16")
    ref = np.asarray(jax_attention(jq, jk, jv, window=window,
                                   implementation="pallas", block_q=64,
                                   block_k=64), np.float32)
    out = ops.attention(tq, tk, tv, window=window).float().numpy()
    assert (np.abs(out - ref) <= _bf16_ulp_bound(ref)).all()


def test_plain_matches_reference_attention_gqa_window():
    (jq, tq), (jk, tk), (jv, tv) = _inputs(4, 2, 72, 8, 2, 16, "float32")
    ref = ja.reference_attention(jq, jk, jv, causal=True, window=20)
    _close(fa.flash_attention_plain(tq, tk, tv, True, 20), ref, 2e-5)
    _close(ta.reference_attention(tq, tk, tv, causal=True, window=20), ref,
           2e-5)


@pytest.mark.parametrize("window", [0, -3])
def test_attention_rejects_empty_window(window):
    t = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="window"):
        ops.attention(t, t, t, window=window)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises; it never computes on the
    CPU itself (the dispatcher picks the plain version for CPU tensors)."""
    t = torch.zeros(1, 8, 2, 16)
    before = fa.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(t, t, t)
    assert fa.launches == before


@pytest.mark.parametrize("cache_len", [1, 9, 16])
def test_decode_attention_matches_reference(cache_len):
    rng = np.random.default_rng(cache_len)
    b, cap, hq, hkv, hd = 2, 16, 8, 2, 16
    q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
    kc = rng.normal(size=(b, cap, hkv, hd)).astype(np.float32)
    vc = rng.normal(size=(b, cap, hkv, hd)).astype(np.float32)
    ref = ja.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(cache_len, jnp.int32))
    out = ta.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), cache_len)
    _close(out, ref, 2e-5)
    # the same token as the last row of a full pass with a query offset
    pos = cache_len - 1
    full = ta.reference_attention(torch.from_numpy(q),
                                  torch.from_numpy(kc[:, :cache_len]),
                                  torch.from_numpy(vc[:, :cache_len]),
                                  q_offset=pos)
    _close(out, full.numpy(), 2e-5)


# ---------------------------------------------------------------------------
# the wrapper's layout rule and kernel variant, as a function of shapes,
# strides, element size and base addresses (no card needed)
# ---------------------------------------------------------------------------

def _layout(b=2, s=64, hq=8, hkv=2, hd=64, elt=2, fused=False):
    """(shapes, strides, bases) of contiguous q/k/v, or of views into one
    fused (B, S, (Hq + 2 Hkv) * hd) projection."""
    shapes = [(b, s, h, hd) for h in (hq, hkv, hkv)]
    if fused:
        row = (hq + 2 * hkv) * hd
        strides = [(s * row, row, hd, 1)] * 3
        bases = [4096, 4096 + hq * hd * elt, 4096 + (hq + hkv) * hd * elt]
    else:
        strides = [(s * h * hd, h * hd, hd, 1) for h in (hq, hkv, hkv)]
        bases = [4096, 1 << 20, 1 << 21]
    return shapes, strides, bases


@pytest.mark.parametrize("elt,hd,variant", [
    (2, 64, "wgmma_tma"), (2, 128, "wgmma_tma"),
    (2, 16, "mma_sync"), (2, 32, "mma_sync"), (2, 80, "wgmma_tma"),
    (2, 96, "wgmma_tma"), (2, 192, "wgmma_tma"),
    (4, 16, "mma_fma"), (4, 32, "mma_fma"), (4, 64, "mma_fma"),
    (4, 80, "mma_fma"), (4, 96, "mma_fma"), (4, 128, "mma_fma"),
    (4, 192, "mma_fma"),
    (2, 48, "wgmma_tma"), (2, 256, "wgmma_cols"),
])
@pytest.mark.parametrize("fused", [False, True], ids=["contiguous", "fused"])
def test_check_layout_names_the_variant(elt, hd, variant, fused):
    shapes, strides, bases = _layout(hd=hd, elt=elt, fused=fused)
    assert fa.check_layout(shapes, strides, elt, bases) == variant


@pytest.mark.parametrize("case,match", [
    ("head_dim 0", "head_dim"),
    ("head_dim 513", "head_dim"),
    ("row stride 8 bytes off", "16-byte"),
    ("base 8 bytes off", "16-byte"),
    ("last stride 2", "unit last stride"),
    ("zero head stride", "2\\*\\*40"),
    ("stride of 2**40 bytes", "2\\*\\*40"),
])
def test_check_layout_refuses_what_a_tma_map_cannot_take(case, match):
    """Head dims out of range, a last stride other than 1 and strides a TMA
    map cannot hold (0, 2**40 bytes) raise, naming the limit; rows off 16
    bytes, which a TMA map cannot take either, are not refused: they go to
    the column-block kernel's cp.async route."""
    shapes, strides, bases = _layout()
    strides = [list(st) for st in strides]
    if case.startswith("head_dim"):
        hd = int(case.split()[1])
        shapes = [sh[:3] + (hd,) for sh in shapes]
    elif case == "row stride 8 bytes off":
        strides[1][1] += 4                      # k: 8 bytes more a row
    elif case == "base 8 bytes off":
        bases[2] += 8
    elif case == "last stride 2":
        strides[0][3] = 2
    elif case == "zero head stride":
        strides[1][2] = 0                       # k broadcast over its heads
    else:
        strides[0][0] = 2 ** 39                 # q's batch stride: 2**40 bytes
    if match == "16-byte":
        assert fa.check_layout(shapes, strides, 2, bases) == "wgmma_cp_async"
        return
    with pytest.raises(ValueError, match=match):
        fa.check_layout(shapes, strides, 2, bases)


@pytest.mark.parametrize("fused", [False, True], ids=["contiguous", "fused"])
@pytest.mark.parametrize("case", ["zero head stride", "stride of 2**40 bytes"])
@pytest.mark.parametrize("hd", [80, 96, 192])
def test_check_layout_holds_the_tma_rule_at_hd_80_96_192(hd, case, fused):
    """bf16 at head_dim 80 / 96 / 192 runs the wgmma kernel, so a layout
    that a TMA map cannot take raises (the mma kernel took a zero stride);
    float32 at the same head dims stays on the FMA kernel and takes it."""
    shapes, strides, bases = _layout(hd=hd, fused=fused)
    assert fa.check_layout(shapes, strides, 2, bases) == "wgmma_tma"
    strides = [list(st) for st in strides]
    if case == "zero head stride":
        strides[2][2] = 0                       # v broadcast over its heads
    else:
        strides[1][0] = 2 ** 39                 # k's batch stride: 2**40 bytes
    with pytest.raises(ValueError, match="2\\*\\*40"):
        fa.check_layout(shapes, strides, 2, bases)
    if case == "zero head stride":
        bases4 = [b * 2 for b in bases]
        assert fa.check_layout(shapes, strides, 4, bases4) == "mma_fma"


def test_check_layout_ignores_the_stride_of_a_size_one_dim():
    """A dimension of size 1 is never stepped over: B = 1, S = 1 or H = 1
    may carry any stride (as a sliced or unsqueezed view does), on every
    variant; the mma kernel also takes a zero stride elsewhere."""
    shapes = [(1, 1, 1, 64)] * 3
    strides = [(3, 5, 7, 1)] * 3
    assert fa.check_layout(shapes, strides, 2, [0, 16, 32]) == "wgmma_tma"
    assert fa.check_layout(shapes, strides, 4, [0, 16, 32]) == "mma_fma"
    shapes, strides, bases = _layout(hd=32)
    strides[1] = (strides[1][0], strides[1][1], 0, 1)   # k broadcast
    assert fa.check_layout(shapes, strides, 2, bases) == "mma_sync"


@pytest.mark.parametrize("arch,hd", [("zamba2-2.7b", 80),
                                     ("phi-3-vision-4.2b", 96),
                                     ("nemotron-4-340b", 192)])
def test_model_paths_hand_the_wgmma_kernel_a_layout_it_takes(arch, hd,
                                                             monkeypatch):
    """The paths that reach attention at head_dim 80 / 96 / 192 (zamba2's
    shared block, phi-3-vision with and without patch embeddings,
    nemotron's heads), reduced, on the CPU: ``prefill`` and ``forward``
    hand the op q / k / v whose layouts, read as the bf16 tensors the card
    would get (the same element strides, offsets at 2 bytes an element),
    pass ``check_layout``'s TMA rule and name ``wgmma_tma``."""
    from repro_torch import configs
    from repro_torch.models.transformer import LM
    from repro_torch.serve.decode import prefill
    cfg = configs.reduced(configs.get_config(arch), dtype="float32",
                          head_dim=hd)
    seen, op = [], ops.flash_attention_op

    def probe(q, k, v, causal, window):
        ts = (q, k, v)
        seen.append(fa.check_layout(
            [t.shape for t in ts], [t.stride() for t in ts], 2,
            [4096 + 2 * t.storage_offset() for t in ts]))
        return op(q, k, v, causal, window)

    monkeypatch.setattr(ops, "flash_attention_op", probe)
    lm = LM.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)))
    kw = {}
    if cfg.num_patches:
        kw["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(2, cfg.num_patches, cfg.d_model)),
            dtype=torch.float32)
    with torch.inference_mode():
        prefill(lm.compute_params(), cfg, toks, 48)
        lm(toks, **kw)
    per_pass = cfg.num_layers // (cfg.attn_every or 1)
    assert seen == ["wgmma_tma"] * 2 * per_pass


# ---------------------------------------------------------------------------
# training: blocked_attention and the autograd Function around the kernel
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """One intra-op thread for the small-tensor training tests: the suite
    runs six workers on eight cores, and torch's default thread pool per
    worker oversubscribes the cores; its spinning threads made a 60-step
    test take 210 s there against 5 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BLOCKED_CASES = [  # s, hq, hkv, hd, causal, window, block
    (64, 4, 2, 16, True, None, 32),
    (160, 2, 2, 32, True, 48, 32),
    (96, 4, 1, 16, False, None, 64),
    (130, 4, 4, 16, True, None, 64),      # ragged last key block
    (100, 4, 2, 16, False, 30, 32),
]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("s,hq,hkv,hd,causal,window,block", BLOCKED_CASES)
def test_blocked_attention_matches_reference(s, hq, hkv, hd, causal, window,
                                             block):
    """The backward's recompute, forward and grads, against the reference's
    ``blocked_attention`` in float32: forward 2e-5, grads 1e-4.  (XLA's CPU
    dot here refuses the reference's bf16 x bf16 -> float32 products.)"""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(s + hd, 2, s, hq, hkv, hd,
                                           "float32")
    kw = dict(causal=causal, window=window, block_q=block, block_k=block)
    ref = ja.blocked_attention(jq, jk, jv, **kw)
    out = ta.blocked_attention(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype
    _close(out, ref, 2e-5)
    w = np.random.default_rng(s).normal(size=out.shape).astype(np.float32)
    jg = jax.grad(lambda *x: (ja.blocked_attention(*x, **kw) * w).sum(),
                  argnums=(0, 1, 2))(jq, jk, jv)
    ins = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    (ta.blocked_attention(*ins, **kw) * torch.from_numpy(w)).sum().backward()
    for x, g in zip(ins, jg):
        _close(x.grad, g, 1e-4)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 4)])
def test_flash_attention_function_gradcheck(causal, window):
    """float64 on the CPU: the forward is the kernel's plain version, the
    backward autograd through ``blocked_attention``; gradcheck holds the
    one against the derivative of the other."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 9, h, 4)))
               .requires_grad_() for h in (4, 2, 2))
    assert torch.autograd.gradcheck(
        lambda *x: ops.attention(*x, causal=causal, window=window),
        (q, k, v))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 20)])
def test_flash_attention_grads_match_pallas_vjp(causal, window):
    """As ``tests/test_kernels.py:55-70``: the grads of the sum through the
    port's Function against ``jax.grad`` through the reference's
    ``custom_vjp`` (the Pallas forward in interpret mode, the recompute
    through ``blocked_attention``), 1e-4."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(1, 1, 64, 4, 2, 16, "float32")
    jg = jax.grad(lambda *x: jax_attention(
        *x, causal=causal, window=window, implementation="pallas",
        block_q=32, block_k=32).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    ins = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = ops.attention(*ins, causal=causal, window=window)
    assert out.grad_fn is not None
    out.sum().backward()
    for x, g in zip(ins, jg):
        assert x.grad.shape == x.shape
        _close(x.grad, g, 1e-4)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("sq,skv", [(12, 40), (17, 5)])
def test_cross_attention_grads_match_pallas_vjp(sq, skv):
    """Non-causal with Sq != Skv: the grads through the port's Function
    against ``jax.grad`` through the reference's ``custom_vjp``, 1e-4; and
    ``gradcheck`` of the Function in float64."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(2, 1, sq, 4, 2, 16, "float32",
                                           skv=skv)
    jg = jax.grad(lambda *x: jax_attention(
        *x, causal=False, implementation="pallas", block_q=16,
        block_k=16).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    ins = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    ops.attention(*ins, causal=False).sum().backward()
    for x, g in zip(ins, jg):
        assert x.grad.shape == x.shape
        _close(x.grad, g, 1e-4)
    small = [x.detach()[:, :n].double().requires_grad_()
             for x, n in zip(ins, (6, 4, 4))]      # 6 q rows, 4 keys
    assert torch.autograd.gradcheck(
        lambda *x: ops.attention(*x, causal=False), small)


def test_kernel_wrapper_refuses_inputs_that_require_grad():
    """A direct call under grad would return an output without a grad_fn
    and cut the graph silently: it raises, naming the Function's route."""
    t = torch.zeros(1, 8, 2, 16)
    before = fa.launches
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(t.clone().requires_grad_(), t, t)
    with pytest.raises(RuntimeError, match="kernels.ops"):
        fa.flash_attention(t, t, t.clone().requires_grad_())
    # with grad off (serving runs under inference_mode) the guard stands
    # aside, and this CPU tensor is refused as before
    with torch.inference_mode(), pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(t.clone().requires_grad_(), t, t)
    assert fa.launches == before
