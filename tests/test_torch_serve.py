"""Port vs reference: serving.

The port's one-pass ``prefill`` (one forward over the prompt, K/V written
into the cache) against the reference's token-by-token ``prefill``; then
decode steps against the reference's ``decode_step``; all in float32 on the
reference's own params, tolerance 1e-4 on logits and caches (the same
float32 formulas summed in other orders).

The ssm family (reduced rwkv6-3b): the port's prefill runs the recurrence
chunked in one pass, the reference's token by token, so in float32 the two
differ by summation order; logits and ``rwkv_S`` are held at 5e-4, the
chunked kernel's own tolerance against the sequential oracle
(``tests/test_kernels.py:114``), the token-shift vectors at 1e-5, and the
greedy tokens must be identical.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro_torch import bridge, configs as tcfg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import LM, forward  # noqa: E402
from repro_torch.serve import decode as TD  # noqa: E402
from repro_torch.serve.kv_cache import init_decode_state  # noqa: E402

TOL = 1e-4
SSM_TOL = 5e-4


def _setup(arch="tinyllama-1.1b", **over):
    over.setdefault("dtype", "float32")
    jc = jcfg.reduced(jcfg.get_config(arch), **over)
    tc = tcfg.reduced(tcfg.get_config(arch), **over)
    npp = jax.tree_util.tree_map(np.asarray,
                                 JT.init_lm(jc, jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = bridge.params_from_numpy(npp, device="cpu")
    return jc, tc, jp, tp


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("over,s,max_len", [
    ({}, 12, 24),
    ({"sliding_window": 8}, 12, 24),     # rolling cache shorter than prompt
], ids=["full-cache", "rolling-window"])
def test_prefill_matches_reference(over, s, max_len):
    jc, tc, jp, tp = _setup(**over)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (2, s))
    jl, jst = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32), max_len)
    tl, tst = TD.prefill(tp, tc, torch.as_tensor(toks), max_len)
    assert tuple(tl.shape) == tuple(jl.shape) == (2, 1, jc.vocab_size)
    _close(tl, jl)
    assert tst["cache_len"] == int(jst["cache_len"]) == s
    cap = jst["k_cache"].shape[2]
    assert tuple(tst["k_cache"].shape) == tuple(jst["k_cache"].shape)
    written = np.arange(max(0, s - cap), s) % cap
    for name in ("k_cache", "v_cache"):
        _close(tst[name][:, :, written], np.asarray(jst[name])[:, :, written])
        assert tst[name].dtype == torch.float32


def test_decode_steps_match_reference_and_greedy_tokens_agree():
    jc, tc, jp, tp = _setup()
    toks = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 10))
    jl, jst = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32), 16)
    tl, tst = TD.prefill(tp, tc, torch.as_tensor(toks), 16)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = tl.argmax(dim=-1)
    for _ in range(4):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jst = JD.decode_step(jp, jc, jtok, jst)
        tl, tst = TD.decode_step(tp, tc, ttok, tst)
        _close(tl, jl)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(dim=-1)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert tst["cache_len"] == int(jst["cache_len"]) == 14
    _close(tst["k_cache"][:, :, :14], np.asarray(jst["k_cache"])[:, :, :14])


def test_decode_matches_teacher_forced_forward_bf16():
    """In the port alone, bf16: the last decode logits against a forward pass
    over prompt + generated tokens (tests/test_serve.py's tolerance)."""
    _, tc, _, tp = _setup(dtype="bfloat16")
    lm = LM(tc, tp)
    prompts = tserve.make_prompts(tc, 2, 12, seed=4, device="cpu")
    res = tserve.generate(lm, prompts, gen=5)
    full, _ = forward(lm.compute_params(), tc,
                      torch.cat([prompts, res.tokens[:, :-1]], dim=1))
    _close(res.last_logits[:, 0].float(), full[:, -1].float().numpy(),
           tol=0.05)
    assert res.tokens.shape == (2, 5)


def test_serve_main_runs_on_cpu(capsys):
    fa.launches = 7
    res = tserve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert res.tokens.shape == (2, 3)
    assert "prefill 2x8 tokens" in out and "tok/s" in out
    # the CPU path runs the plain version: no kernel launch
    assert "flash-attention kernel launches: 0" in out


def test_serve_main_rejects_zero_gen():
    with pytest.raises(SystemExit):
        tserve.main(["--reduced", "--device", "cpu", "--gen", "0"])


def test_unknown_arch_is_refused():
    assert "gpt-2-xl" not in jcfg.list_configs()
    with pytest.raises(KeyError, match="tinyllama"):
        tserve.main(["--arch", "gpt-2-xl", "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen1.5-32b",
                                  "nemotron-4-340b"])
def test_dense_configs_prefill_and_decode_match_reference(arch):
    """The rest of the dense family (nonparam LayerNorm and tied embeddings,
    QKV bias, squared-ReLU with LayerNorm and head_dim 192's reduced
    stand-in), reduced, float32: prefill and 3 decode steps against the
    reference's, 1e-4, with identical greedy tokens."""
    jc, tc, jp, tp = _setup(arch)
    toks = np.random.default_rng(8).integers(0, jc.vocab_size, (2, 10))
    jl, jst = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32), 16)
    tl, tst = TD.prefill(tp, tc, torch.as_tensor(toks), 16)
    _close(tl, jl)
    for _ in range(3):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(dim=-1)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jst = JD.decode_step(jp, jc, jtok, jst)
        tl, tst = TD.decode_step(tp, tc, ttok, tst)
        _close(tl, jl)


def test_rolling_cache_state_shape():
    cfg = tcfg.reduced(tcfg.get_config("tinyllama-1.1b"), sliding_window=8)
    st = init_decode_state(cfg, 1, max_len=64, dtype=torch.float32,
                           device="cpu")
    assert st["k_cache"].shape[2] == 8 and st["cache_len"] == 0


# ---------------------------------------------------------------------------
# ssm family: reduced rwkv6-3b
# ---------------------------------------------------------------------------

def _close_ssm_state(tst, jst):
    _close(tst["rwkv_S"], jst["rwkv_S"], SSM_TOL)
    for name in ("tmix_last", "cmix_last"):
        _close(tst[name], jst[name], 1e-5)
        assert tst[name].dtype == torch.float32
    assert tst["rwkv_S"].dtype == torch.float32
    assert tst["cache_len"] == int(jst["cache_len"])


@pytest.mark.parametrize("s", [12, 7], ids=["chunk-12", "chunk-7"])
def test_ssm_prefill_and_decode_match_reference(s):
    jc, tc, jp, tp = _setup("rwkv6-3b")
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (2, s))
    jl, jst = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32), s + 8)
    tl, tst = TD.prefill(tp, tc, torch.as_tensor(toks), s + 8)
    assert tuple(tl.shape) == tuple(jl.shape) == (2, 1, jc.vocab_size)
    _close(tl, jl, SSM_TOL)
    assert set(tst) == set(jst)
    for name in ("rwkv_S", "tmix_last", "cmix_last"):
        assert tuple(tst[name].shape) == tuple(jst[name].shape)
    _close_ssm_state(tst, jst)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = tl.argmax(dim=-1)
    for _ in range(4):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jst = JD.decode_step(jp, jc, jtok, jst)
        tl, tst = TD.decode_step(tp, tc, ttok, tst)
        _close(tl, jl, SSM_TOL)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(dim=-1)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _close_ssm_state(tst, jst)
    assert tst["cache_len"] == s + 4


def test_ssm_decode_matches_teacher_forced_forward_bf16():
    """In the port alone, bf16: the last decode logits against a forward pass
    over prompt + generated tokens (tests/test_serve.py's tolerance)."""
    _, tc, _, tp = _setup("rwkv6-3b", dtype="bfloat16")
    lm = LM(tc, tp)
    prompts = tserve.make_prompts(tc, 2, 16, seed=4, device="cpu")
    res = tserve.generate(lm, prompts, gen=5)
    full, _ = forward(lm.compute_params(), tc,
                      torch.cat([prompts, res.tokens[:, :-1]], dim=1))
    np.testing.assert_allclose(res.last_logits[:, 0].float().numpy(),
                               full[:, -1].float().numpy(), atol=0.15,
                               rtol=0.05)


def test_ssm_state_constant_memory():
    """Twin of tests/test_serve.py: the RWKV decode state is O(1) in the
    context length."""
    cfg = tcfg.reduced(tcfg.get_config("rwkv6-3b"))
    s1 = init_decode_state(cfg, 1, max_len=128, device="cpu")
    s2 = init_decode_state(cfg, 1, max_len=1 << 19, device="cpu")

    def size(st):
        return sum(v.numel() for v in st.values() if torch.is_tensor(v))
    assert size(s1) == size(s2) > 0
    assert s1["rwkv_S"].dtype == torch.float32
    assert s1["tmix_last"].dtype == torch.bfloat16


def test_serve_main_runs_rwkv6_on_cpu(capsys):
    res = tserve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert res.tokens.shape == (2, 3)
    assert "rwkv6-3b on cpu" in out
    for name in ("flash-attention", "rwkv6"):
        assert f"{name} kernel launches: 0" in out
