"""Port vs reference: attention.

The port's ``kernels.ops.attention`` on CPU tensors runs the Hopper kernel's
plain version; it is held against the reference's Pallas kernel
(``attention(implementation="pallas")``, interpret mode on the CPU) on the
shapes and masks of ``tests/test_kernels.py``, with its tolerances: float32
2e-5, bf16 2e-2.  ``decode_attention`` is held against the reference's at
float32 2e-5.
"""

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


def _inputs(seed, b, s, hq, hkv, hd, dtype):
    """Same values for both frameworks: numpy normals rounded to `dtype`."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for h in (hq, hkv, hkv):
        x = jnp.asarray(rng.normal(size=(b, s, h, hd)), jdt)
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


def _bf16_ulp_bound(ref):
    """One bf16 ulp of |ref|, at least 8e-3 (the ulp below 2)."""
    mag = np.maximum(np.abs(ref), 1e-30)
    return np.maximum(8e-3, 2.0 ** (np.floor(np.log2(mag)) - 7))


@pytest.mark.parametrize("b,s,hq,hkv,hd,window", [
    (2, 128, 4, 4, 32, None),
    (1, 256, 8, 2, 64, None),
    (2, 96, 4, 1, 16, None),
    (1, 320, 4, 2, 64, 48),
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
    (2, 16, "mma_sync"), (2, 32, "mma_sync"),
    (4, 16, "mma_fma"), (4, 32, "mma_fma"), (4, 64, "mma_fma"),
    (4, 128, "mma_fma"),
])
@pytest.mark.parametrize("fused", [False, True], ids=["contiguous", "fused"])
def test_check_layout_names_the_variant(elt, hd, variant, fused):
    shapes, strides, bases = _layout(hd=hd, elt=elt, fused=fused)
    assert fa.check_layout(shapes, strides, elt, bases) == variant


@pytest.mark.parametrize("case,match", [
    ("head_dim 48", "head_dim"),
    ("head_dim 256", "head_dim"),
    ("row stride 8 bytes off", "16-byte"),
    ("base 8 bytes off", "16-byte"),
    ("last stride 2", "unit last stride"),
    ("zero head stride", "2\\*\\*40"),
    ("stride of 2**40 bytes", "2\\*\\*40"),
])
def test_check_layout_refuses_what_a_tma_map_cannot_take(case, match):
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
    with pytest.raises(ValueError, match=match):
        fa.check_layout(shapes, strides, 2, bases)


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
