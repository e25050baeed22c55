"""The port's CUDA kernel on the card, against its plain version.

Needs an NVIDIA card and nvcc; imports no JAX, so it runs where the port
runs.  Elsewhere every test skips (decided inside the ``cuda`` fixture, at
run time).  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: bf16 2e-2 (the kernel rounds P to bf16 before the PV product,
the plain version does not; tests/test_kernels.py's bf16 bound), float32
1e-4 (same f32 arithmetic in another summation order, no TF32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import LM, forward  # noqa: E402
from repro_torch.serve.decode import prefill  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, s, hq, hkv, hd, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, s, h, hd, generator=g).to(dev, dtype)
            for h in (hq, hkv, hkv)]


def _check(q, k, v, **kw):
    before = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, kw.get("causal", True),
                                   kw.get("window"))
    tol = TOL[q.dtype]
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
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


def test_dispatch_sends_cuda_tensors_to_the_kernel(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 32, torch.bfloat16)
    before = fa.launches
    out = ops.attention(q, k, v)
    assert fa.launches == before + 1 and out.is_cuda


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3),
                           k, v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :, :3].contiguous(), k, v)


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
        ref = forward(lm_cpu.compute_params(), cfg, toks)[:, -1:]
    torch.testing.assert_close(logits.cpu(), ref, atol=1e-4, rtol=1e-4)
