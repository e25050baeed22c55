"""Port vs reference: norms, activations, RoPE and the MLP on the same numpy
inputs, float32, atol 1e-6 (the two compute the same float32 formulas; only
the libraries' rounding differs)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jc  # noqa: E402
from repro.models import mlp as jm  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import mlp as tm  # noqa: E402

ATOL = 1e-6


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norm_apply(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    params = {}
    if kind != "nonparam_ln":
        params["scale"] = rng.normal(size=(64,)).astype(np.float32)
    if kind == "layernorm":
        params["bias"] = rng.normal(size=(64,)).astype(np.float32)
    jx, tx = _both(x)
    ref = jc.norm_apply(kind, {k: jnp.asarray(v) for k, v in params.items()},
                        jx)
    out = tc.norm_apply(kind, {k: torch.from_numpy(v)
                               for k, v in params.items()}, tx)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu2"])
def test_activation(kind):
    x = np.random.default_rng(1).normal(size=(3, 7, 32)).astype(np.float32)
    jx, tx = _both(x)
    np.testing.assert_allclose(tc.activation(kind, tx).numpy(),
                               np.asarray(jc.activation(kind, jx)), atol=ATOL)


@pytest.mark.parametrize("hd", [16, 64])
def test_apply_rope(hd):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 3, hd)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)[None, :] + 5
    ref = jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    out = tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_apply_rope_bf16_casts_back():
    x = torch.randn(1, 4, 2, 16, dtype=torch.bfloat16)
    out = tc.apply_rope(x, torch.arange(4)[None], 1e4)
    assert out.dtype == torch.bfloat16
    # position 0 is the identity rotation
    assert torch.equal(out[:, 0], x[:, 0])


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply(act):
    rng = np.random.default_rng(3)
    d, f = 32, 48
    params = {"w_up": rng.normal(size=(d, f)) / np.sqrt(d),
              "w_down": rng.normal(size=(f, d)) / np.sqrt(f)}
    if act == "silu":
        params["w_gate"] = rng.normal(size=(d, f)) / np.sqrt(d)
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    ref = jm.mlp_apply({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x), act)
    out = tm.mlp_apply({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
