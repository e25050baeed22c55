"""Port vs reference: the hybrid family (``repro_torch.models.ssm``'s
Mamba2, and zamba2-2.7b through ``transformer`` and ``serve``).

Same numpy inputs, or the reference's own params through
``bridge.params_from_numpy``, in both packages; float32 unless noted:
* (the config copy is held field by field in ``tests/test_torch_model.py``)
* ``_causal_conv`` with and without a trailing context: y and the new
  context within 1e-6 (the same four products and three sums);
* ``mamba2_apply`` over a sequence, at reduced zamba2's shape (K 16, 4
  heads of 32) and at a narrow case with the served path's K 64 / V 128
  (d_model 128, expand 2, 2 heads of 128): y, final S and conv context
  within 1e-5 (the recurrence's plain version against the reference's jnp
  chunk scan, the same float32 formulas in another summation order); one
  decode step from a random state, 1e-5;
* bf16 ``mamba2_apply`` against the reference's bf16: 0.15 / 0.05 on y,
  the serving tests' bf16 bound (``tests/test_serve.py:60-62``): both round
  the projections, conv, gates and norm to bf16 at each operation, in
  places and orders that differ (the products' bf16 outputs, XLA's bf16
  silu); the float32 state 1e-2, since dt comes from a bf16 projection
  whose rounding may differ by one bf16 ulp (0.4%) and scales every k and
  log decay; the conv context, bf16 values of the same product, one bf16
  ulp (8e-3);
* the kernel operands ``mamba2_apply`` builds: float32, q broadcast over
  the heads (zero head stride) and each with unit inner stride, passing
  every check of the kernel's wrapper up to the device;
* reduced zamba2 (4 layers, attn_every 2): ``forward`` 1e-4; the one-pass
  ``prefill`` against the reference's token-by-token ``prefill`` (last
  logits, ``mamba_ssm``, ``mamba_conv`` and both application points'
  caches), 1e-4; three ``decode_step`` s, 1e-4, identical greedy tokens;
  ``LM`` / ``generate`` give the reference's greedy tokens; ``lm_loss`` and
  every grad against ``jax.value_and_grad``: loss 1e-5, grads 1e-4 (the
  backward of the inclusive recurrence through the head-broadcast views);
* the layout of the port's init, the float32 leaves of the compute copy,
  and ``launch.serve.main`` on the CPU.

    PYTHONPATH=src python -m pytest -q tests/test_torch_hybrid.py
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro_torch import bridge, configs as tcfg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6 as kr  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import decode as TD  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.train.tree import flatten  # noqa: E402

ARCH = "zamba2-2.7b"


def _cfgs(dtype="float32", **over):
    over = {"dtype": dtype, "num_layers": 4, **over}
    return (jcfg.reduced(jcfg.get_config(ARCH), **over),
            tcfg.reduced(tcfg.get_config(ARCH), **over))


@functools.lru_cache(maxsize=None)
def _npp(seed=0):
    jc, _ = _cfgs()
    return jax.tree_util.tree_map(np.asarray,
                                  JT.init_lm(jc, jax.random.PRNGKey(seed)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# conv, the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    st = (rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state
          else None)
    y, tail = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              None if st is None else torch.from_numpy(st))
    jy, jtail = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    _close(y, jy, 1e-6)
    _close(tail, jtail, 1e-6)
    assert tuple(tail.shape) == (2, 3, 24)


# (d_model, ssm_state, heads, expand): reduced zamba2, and the path's K / V
MAMBA_CASES = {"reduced": (64, 16, 4, 2), "k64-v128": (128, 64, 2, 2)}


def _mamba_case(name, dtype="float32", seed=3, b=2, t=32):
    d, n, h, e = MAMBA_CASES[name]
    npp = jax.tree_util.tree_map(np.asarray, JS.mamba2_init(
        jax.random.PRNGKey(seed), d, n, h, e))
    rng = np.random.default_rng(seed)
    # a nonzero A and dt bias, so that the decay is not the init's alone
    npp["a_log"] = rng.normal(size=h).astype(np.float32) * 0.5
    npp["dt_bias"] = rng.normal(size=h).astype(np.float32) * 0.5
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.array(jx, np.float32))
    if dtype == "bfloat16":
        tx = tx.bfloat16()
    return (d, n, h, e), npp, jx, tx


@pytest.mark.parametrize("name", sorted(MAMBA_CASES))
def test_mamba2_apply_matches_reference(name):
    (_, n, h, e), npp, jx, tx = _mamba_case(name)
    y, st = TS.mamba2_apply(bridge.params_from_numpy(npp, device="cpu"), tx,
                            h, n, e, chunk=16)
    jy, jst = JS.mamba2_apply(_jnp(npp), jx, h, n, e, chunk=16)
    assert y.dtype == torch.float32 and st["ssm"].dtype == torch.float32
    assert tuple(st["ssm"].shape) == jst["ssm"].shape
    _close(y, jy, 1e-5)
    _close(st["ssm"], jst["ssm"], 1e-5)
    _close(st["conv"], jst["conv"], 1e-5)


@pytest.mark.parametrize("name", sorted(MAMBA_CASES))
def test_mamba2_decode_step_matches_reference(name):
    (d, n, h, e), npp, jx, tx = _mamba_case(name, t=1)
    rng = np.random.default_rng(4)
    S = rng.normal(size=(2, h, n, d * e // h)).astype(np.float32)
    conv = rng.normal(size=(2, 3, d * e)).astype(np.float32)
    y, st = TS.mamba2_apply(bridge.params_from_numpy(npp, device="cpu"), tx,
                            h, n, e, state={"ssm": torch.from_numpy(S),
                                            "conv": torch.from_numpy(conv)})
    jy, jst = JS.mamba2_apply(_jnp(npp), jx, h, n, e,
                              state={"ssm": jnp.asarray(S),
                                     "conv": jnp.asarray(conv)})
    _close(y, jy, 1e-5)
    _close(st["ssm"], jst["ssm"], 1e-5)
    _close(st["conv"], jst["conv"], 1e-5)


def test_mamba2_apply_bf16_matches_reference():
    """bf16 activations, float32 weights cast at each product, in both
    packages (tolerances: the module docstring)."""
    (_, n, h, e), npp, jx, tx = _mamba_case("k64-v128", "bfloat16")
    y, st = TS.mamba2_apply(bridge.params_from_numpy(npp, device="cpu"), tx,
                            h, n, e, chunk=16)
    jy, jst = JS.mamba2_apply(_jnp(npp), jx, h, n, e, chunk=16)
    assert y.dtype == torch.bfloat16 and st["conv"].dtype == torch.bfloat16
    assert st["ssm"].dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), atol=0.15, rtol=0.05)
    np.testing.assert_allclose(_np(st["ssm"]), _np(jst["ssm"]), atol=1e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(_np(st["conv"]), _np(jst["conv"]), atol=8e-3,
                               rtol=8e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_kernel_operands_pass_the_wrappers_checks(dtype, monkeypatch):
    """What the card's kernel would be handed: float32 q, k, v and log
    decay, q the head broadcast of C (head stride 0, not copied per head),
    each with unit inner stride; the wrapper's every check passes but the
    last, which wants CUDA tensors."""
    (_, n, h, e), npp, _, tx = _mamba_case("k64-v128", dtype)
    seen = []
    mix = ops.rwkv6_mix_state

    def recording(*args, **kw):
        seen.append((args, kw))
        return mix(*args, **kw)
    monkeypatch.setattr(ops, "rwkv6_mix_state", recording)
    TS.mamba2_apply(bridge.params_from_numpy(npp, device="cpu"), tx, h, n, e,
                    chunk=16)
    (q, k, v, ld), kw = seen[0]
    assert kw == {"chunk": 16} and len(seen) == 1
    assert all(x.dtype == torch.float32 for x in (q, k, v, ld))
    assert q.stride(1) == 0 and ld.is_contiguous()
    with pytest.raises(ValueError, match="CUDA device"):
        kr._check(q, k, v, ld, None, 16, None, None)


# ---------------------------------------------------------------------------
# the model: forward, serving, loss and grads
# ---------------------------------------------------------------------------

def test_forward_matches_reference():
    jc, tc = _cfgs()
    npp = _npp()
    toks = _tokens(jc)
    ref, ref_aux = JT.forward(_jnp(npp), jc, jnp.asarray(toks, jnp.int32))
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    logits, aux = TT.forward(lm.compute_params(), tc, torch.as_tensor(toks))
    _close(logits, ref, 1e-4)
    assert float(ref_aux) == 0.0 and aux.item() == 0.0
    assert torch.equal(lm(torch.as_tensor(toks)), logits)


def _prefilled(s=10, max_len=16):
    jc, tc = _cfgs()
    npp = _npp()
    jp, tp = _jnp(npp), bridge.params_from_numpy(npp, device="cpu")
    toks = _tokens(jc, s=s, seed=6)
    jl, jst = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32), max_len)
    tl, tst = TD.prefill(tp, tc, torch.as_tensor(toks), max_len)
    return jc, tc, jp, tp, (jl, jst), (tl, tst)


def test_prefill_matches_reference_token_by_token():
    *_, (jl, jst), (tl, tst) = _prefilled()
    _close(tl, jl, 1e-4)
    assert sorted(tst) == sorted(jst)
    for name in ("mamba_ssm", "mamba_conv", "k_cache", "v_cache"):
        assert tuple(tst[name].shape) == tuple(jst[name].shape), name
        assert tst[name].dtype == torch.float32, name
        _close(tst[name], jst[name], 1e-4)
    assert tst["k_cache"].shape[0] == 2           # two application points
    assert tst["cache_len"] == int(jst["cache_len"]) == 10


def test_decode_steps_match_reference():
    jc, tc, jp, tp, (jl, jst), (tl, tst) = _prefilled()
    for _ in range(3):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(dim=-1)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jst = JD.decode_step(jp, jc, jtok, jst)
        tl, tst = TD.decode_step(tp, tc, ttok, tst)
        _close(tl, jl, 1e-4)
    for name in ("mamba_ssm", "mamba_conv", "k_cache", "v_cache"):
        _close(tst[name], jst[name], 1e-4)
    assert np.array_equal(tl.argmax(dim=-1).numpy(),
                          np.asarray(jnp.argmax(jl, axis=-1)))
    assert tst["cache_len"] == int(jst["cache_len"]) == 13


def test_generate_gives_reference_greedy_tokens():
    jc, tc = _cfgs()
    npp = _npp()
    jp = _jnp(npp)
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    prompts = tserve.make_prompts(tc, 2, 12, seed=5, device="cpu")
    res = tserve.generate(lm, prompts, gen=4)
    jl, jst = JD.prefill(jp, jc, jnp.asarray(prompts.numpy(), jnp.int32), 16)
    want = [np.asarray(jnp.argmax(jl, axis=-1))]
    for _ in range(3):
        jl, jst = JD.decode_step(jp, jc, jnp.asarray(want[-1], jnp.int32),
                                 jst)
        want.append(np.asarray(jnp.argmax(jl, axis=-1)))
    assert np.array_equal(res.tokens.numpy(), np.concatenate(want, axis=1))
    _close(res.last_logits, jl, 1e-4)


def test_lm_loss_and_grads_match_reference():
    jc, tc = _cfgs()
    npp = _npp()
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 33)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        return JT.lm_loss(p, jc, jnp.asarray(tokens), jnp.asarray(labels))
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(_jnp(npp))
    params = bridge.params_from_numpy(npp, device="cpu")
    loss, grads = loss_and_grads(tc, params, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(labels))
    assert abs(loss.item() - float(jl)) <= 1e-5
    want = {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(flatten(grads))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=1e-4,
                                   rtol=1e-4, err_msg=path)
    # the recurrence's A and dt bias get a grad through the kernel's Function
    assert np.abs(want["layers/mamba/a_log"]).max() > 1e-6


# ---------------------------------------------------------------------------
# layout, compute copy, the launcher
# ---------------------------------------------------------------------------

def test_port_init_has_reference_layout():
    jc, tc = _cfgs()
    ref = _npp()
    port = bridge.params_to_numpy(TT.init_lm(tc, seed=0, device="cpu"))
    assert (jax.tree_util.tree_map(np.shape, port)
            == jax.tree_util.tree_map(np.shape, ref))
    assert (jax.tree_util.tree_map(lambda a: a.dtype, port)
            == jax.tree_util.tree_map(lambda a: a.dtype, ref))
    m = port["layers"]["mamba"]
    assert (m["a_log"] == 0).all() and (m["d_skip"] == 1).all()
    assert (m["dt_bias"] == 0).all()


def test_compute_copy_keeps_a_and_dt_bias_float32():
    _, tc = _cfgs("bfloat16")
    for dtype in (torch.float32, torch.bfloat16):
        lm = TT.LM.init(tc, seed=2, device="cpu", dtype=dtype)
        m = lm.compute_params()["layers"]["mamba"]
        assert m["a_log"].dtype == m["dt_bias"].dtype == torch.float32
        assert m["norm"]["scale"].dtype == torch.float32
        assert m["w_in"].dtype == m["conv"].dtype == torch.bfloat16
        cp = lm.compute_params()
        assert cp["shared_proj"].dtype == torch.bfloat16
        assert cp["shared_block"]["attn"]["wq"].dtype == torch.bfloat16


def test_serve_main_runs_zamba2_on_cpu(capsys):
    fa.launches = kr.launches = 3
    res = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert res.tokens.shape == (2, 3)
    assert "zamba2-2.7b on cpu" in out
    assert "flash-attention kernel launches: 0" in out
    assert "rwkv6 kernel launches: 0" in out
    assert bool(torch.isfinite(res.last_logits.float()).all())
