"""Port vs reference: the moe family (``repro_torch.models.moe``, and
deepseek-moe-16b / mixtral-8x22b through ``transformer`` and ``serve``).

Same numpy inputs, or the reference's own params through
``bridge.params_from_numpy``, in both packages:
* ``_route``: expert indices, slots and keep identical, gates and aux 1e-6
  (float32; the inputs have no near-tie at the k-th choice, which the test
  asserts, so a differing decision is a fault), with and without drops;
* ``_capacity`` over a grid of (T, k, E, factor): identical;
* ``moe_apply_dense``: 1e-5 in float32 with and without shared experts;
  in bf16 bit-identical to the reference's output when silu rounds as
  XLA's CPU backend rounds it, 2e-2 with ``F.silu`` (one rounding);
* ``forward`` of reduced deepseek-moe-16b and mixtral-8x22b (window 128,
  GQA 4 / 2): logits 1e-4, aux 1e-6;
* serving at ``moe_capacity_factor=16`` (nothing dropped): the port's
  one-pass ``prefill`` and ``decode_step`` against the reference's
  token-by-token ``prefill`` and ``decode_step``, 1e-4, identical greedy
  tokens; at the default 1.25, with drops, the port's prefill equals the
  reference's ``forward`` at the last position, 1e-4;
* ``lm_loss`` with its aux and every grad against ``jax.value_and_grad``:
  loss 1e-5, grads 1e-4;
* ``LM.init(dtype=torch.bfloat16).compute_params()`` is bit-identical to
  the float32 LM's, the router float32 in both, and aliases the held
  weights; ``launch.serve.main`` serves reduced deepseek with bf16 weights.

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe.py
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro_torch import bridge, configs as tcfg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import decode as TD  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.train.tree import flatten  # noqa: E402

ARCHS = {  # arch -> overrides of reduced(): mixtral keeps GQA (4 / 2)
    "deepseek-moe-16b": {},
    "mixtral-8x22b": {"num_kv_heads": 2},
}


def _cfgs(arch, **over):
    over = {"dtype": "float32", **ARCHS[arch], **over}
    return (jcfg.reduced(jcfg.get_config(arch), **over),
            tcfg.reduced(tcfg.get_config(arch), **over))


def _jax_params(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  JT.init_lm(cfg, jax.random.PRNGKey(seed)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# routing and capacity
# ---------------------------------------------------------------------------

ROUTE_CASES = {  # name -> (T, D, E, k, capacity, logit scale)
    "no-drops": (64, 32, 8, 2, 64, 1.0),
    "drops": (64, 32, 8, 2, 8, 3.0),
    "deepseek-like": (48, 64, 64, 6, 16, 3.0),
    "top1": (40, 16, 4, 1, 8, 2.0),
}


@pytest.mark.parametrize("name", sorted(ROUTE_CASES))
def test_route_matches_reference(name):
    t, d, e, k, cap, scale = ROUTE_CASES[name]
    rng = np.random.default_rng(sorted(ROUTE_CASES).index(name))
    x = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, e)) * scale / np.sqrt(d)).astype(np.float32)
    ref = JM._route(jnp.asarray(w), jnp.asarray(x), k, e, cap)
    # no near-tie at the k-th choice: a differing decision would be a fault
    probs = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(x) @ jnp.asarray(w), axis=-1)), axis=-1)[:, ::-1]
    assert (probs[:, k - 1] - probs[:, k] > 1e-5).all()
    got = TM._route(torch.from_numpy(w), torch.from_numpy(x), k, e, cap)
    idx, gates, slot, keep, aux = (np.asarray(a) for a in ref)
    assert np.array_equal(got[0].numpy(), idx)
    assert np.array_equal(got[2].numpy(), slot)
    assert np.array_equal(got[3].numpy(), keep)
    _close(got[1].numpy(), gates, 1e-6)
    assert got[1].dtype == got[4].dtype == torch.float32
    assert abs(got[4].item() - float(aux)) <= 1e-6
    if name == "drops":
        assert not keep.all()
    if name == "no-drops":
        assert keep.all()


@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0, 16.0])
def test_capacity_matches_reference(factor):
    for t in (1, 7, 8, 48, 8192, 8320):
        for k in (1, 2, 6):
            for e in (4, 8, 64):
                assert (TM._capacity(t, k, e, factor)
                        == JM._capacity(t, k, e, factor)), (t, k, e)


# ---------------------------------------------------------------------------
# moe_apply_dense
# ---------------------------------------------------------------------------

def _moe_case(arch, dtype, seed=3, b=2, s=16):
    jc, tc = _cfgs(arch, dtype=dtype)
    npp = jax.tree_util.tree_map(np.asarray, JM.moe_init(
        jax.random.PRNGKey(seed), jc.d_model, jc.moe_num_experts,
        jc.moe_d_ff, jc.moe_shared_experts))
    x = np.random.default_rng(seed).normal(size=(b, s, jc.d_model))
    return jc, tc, npp, x.astype(np.float32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_apply_dense_matches_reference_f32(arch):
    jc, tc, npp, x = _moe_case(arch, "float32")
    assert ("shared" in npp) == (arch == "deepseek-moe-16b")
    ref, ref_aux = JM.moe_apply_dense(_jnp(npp), jnp.asarray(x), jc)
    y, aux = TM.moe_apply_dense(bridge.params_from_numpy(npp, device="cpu"),
                                torch.from_numpy(x), tc)
    assert y.dtype == torch.float32 and y.shape == x.shape
    _close(y.numpy(), ref, 1e-5)
    assert abs(aux.item() - float(ref_aux)) <= 1e-6


def _xla_cpu_silu(x):
    """``jax.nn.silu`` as XLA's CPU backend computes it in bf16: exp,
    1 + ., 1 / . and the product each rounded to bf16.  ``F.silu`` rounds
    once."""
    return x * (1 / (1 + torch.exp(-x)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_apply_dense_bf16_matches_reference(arch, monkeypatch):
    """bf16 activations, float32 weights cast at each product (the router
    stays float32) in both packages.  With the reference's rounding of
    silu the port's output is the reference's to the bit: routing,
    dispatch, the expert products and the combine round alike.  As shipped
    (``F.silu``, one rounding) it is within 2e-2, the bf16 tolerance of
    ``tests/test_kernels.py``."""
    jc, tc, npp, x = _moe_case(arch, "bfloat16")
    xb = jnp.asarray(x, jnp.bfloat16)
    ref, _ = JM.moe_apply_dense(_jnp(npp), xb, jc)
    ref = np.asarray(ref.astype(jnp.float32))
    params = bridge.params_from_numpy(npp, device="cpu")
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    y, _ = TM.moe_apply_dense(params, xt, tc)
    assert y.dtype == torch.bfloat16
    _close(y.float().numpy(), ref, 2e-2)
    monkeypatch.setattr(torch.nn.functional, "silu", _xla_cpu_silu)
    y, _ = TM.moe_apply_dense(params, xt, tc)
    assert np.array_equal(y.float().numpy(), ref)


def test_moe_dispatch_drops_only_over_capacity():
    """Every token routed to expert 2 at capacity 8: only the first 8 are
    served, the others get no output from the routed experts, in both
    packages."""
    jc, tc, npp, x = _moe_case("mixtral-8x22b", "float32", s=12)
    jc, tc = (dataclasses.replace(c, moe_top_k=1, moe_capacity_factor=0.01)
              for c in (jc, tc))
    x[..., 0] = 1.0
    npp["router"] = np.zeros_like(npp["router"])
    npp["router"][0, 2] = 100.0
    y, _ = TM.moe_apply_dense(bridge.params_from_numpy(npp, device="cpu"),
                              torch.from_numpy(x), tc)
    ref, _ = JM.moe_apply_dense(_jnp(npp), jnp.asarray(x), jc)
    _close(y.numpy(), ref, 1e-5)
    y = y.reshape(-1, tc.d_model)
    assert (y[8:] == 0).all() and (y[:8].abs().sum(-1) > 0).all()


# ---------------------------------------------------------------------------
# the model: forward, serving, loss and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", [("deepseek-moe-16b", 24),
                                    ("mixtral-8x22b", 24),
                                    ("mixtral-8x22b", 160)],
                         ids=["deepseek", "mixtral", "mixtral-past-window"])
def test_forward_matches_reference(arch, s):
    jc, tc = _cfgs(arch)
    npp = _jax_params(jc)
    toks = _tokens(jc, s=s)
    ref, ref_aux = JT.forward(_jnp(npp), jc, jnp.asarray(toks, jnp.int32))
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    logits, aux = TT.forward(lm.compute_params(), tc, torch.as_tensor(toks))
    _close(logits.numpy(), ref, 1e-4)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(ref_aux) > 0 and abs(aux.item() - float(ref_aux)) <= 1e-6
    assert torch.equal(lm(torch.as_tensor(toks)), logits)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_match_reference_without_drops(arch):
    jc, tc = _cfgs(arch, moe_capacity_factor=16.0)
    npp = _jax_params(jc)
    jp, tp = _jnp(npp), bridge.params_from_numpy(npp, device="cpu")
    toks = _tokens(jc, s=10, seed=6)
    jl, jst = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32), 16)
    tl, tst = TD.prefill(tp, tc, torch.as_tensor(toks), 16)
    _close(tl, jl, 1e-4)
    assert sorted(tst) == sorted(jst)
    for name in ("k_cache", "v_cache", "k_cache_dense", "v_cache_dense"):
        if name in jst:
            assert tuple(tst[name].shape) == tuple(jst[name].shape)
            _close(tst[name][:, :, :10], np.asarray(jst[name])[:, :, :10],
                   1e-4)
    for _ in range(4):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(dim=-1)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jst = JD.decode_step(jp, jc, jtok, jst)
        tl, tst = TD.decode_step(tp, tc, ttok, tst)
        _close(tl, jl, 1e-4)
    assert np.array_equal(tl.argmax(dim=-1).numpy(),
                          np.asarray(jnp.argmax(jl, axis=-1)))
    assert tst["cache_len"] == int(jst["cache_len"]) == 14


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_equals_reference_forward_with_drops(arch, monkeypatch):
    """At the default factor 1.25 the one-pass prefill routes the whole
    prompt against one capacity and drops pairs, as the reference's
    ``forward`` does; its last-position logits are the forward's."""
    jc, tc = _cfgs(arch)
    assert tc.moe_capacity_factor == 1.25
    npp = _jax_params(jc)
    toks = _tokens(jc, b=4, s=32, seed=2)
    kept = []
    route = TM._route

    def recording_route(*args):
        out = route(*args)
        kept.append(out[3])
        return out
    monkeypatch.setattr(TM, "_route", recording_route)
    tl, _ = TD.prefill(bridge.params_from_numpy(npp, device="cpu"), tc,
                       torch.as_tensor(toks), 40)
    assert kept and not all(bool(k.all()) for k in kept)   # pairs dropped
    ref, _ = JT.forward(_jnp(npp), jc, jnp.asarray(toks, jnp.int32))
    _close(tl[:, 0], np.asarray(ref)[:, -1], 1e-4)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_loss_and_grads_match_reference(arch):
    jc, tc = _cfgs(arch)
    npp = _jax_params(jc)
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 25)).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        return JT.lm_loss(p, jc, jnp.asarray(tokens), jnp.asarray(labels))
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(_jnp(npp))
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
    _, aux = TT.lm_loss(params, tc, torch.from_numpy(tokens),
                        torch.from_numpy(labels))
    assert abs(aux["aux"].item() - float(jaux["aux"])) <= 1e-6
    assert abs(aux["nll"].item() - float(jaux["nll"])) <= 1e-5


# ---------------------------------------------------------------------------
# layout, bf16-held weights, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_init_has_reference_layout(arch):
    jc, tc = _cfgs(arch)
    ref = _jax_params(jc)
    port = bridge.params_to_numpy(TT.init_lm(tc, seed=0, device="cpu"))
    assert (jax.tree_util.tree_map(np.shape, port)
            == jax.tree_util.tree_map(np.shape, ref))
    assert (jax.tree_util.tree_map(lambda a: a.dtype, port)
            == jax.tree_util.tree_map(lambda a: a.dtype, ref))
    assert ("dense_layers" in port) == bool(tc.moe_first_dense)


def test_bf16_held_weights_equal_the_float32_compute_copy():
    _, tc = _cfgs("deepseek-moe-16b", dtype="bfloat16")
    full = TT.LM.init(tc, seed=4, device="cpu")
    held = TT.LM.init(tc, seed=4, device="cpu", dtype=torch.bfloat16)
    want, got = dict(flatten(full.compute_params())), dict(
        flatten(held.compute_params()))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), path
    for lm in (full, held):
        cp = lm.compute_params()
        assert cp["layers"]["moe"]["router"].dtype == torch.float32
        assert cp["layers"]["moe"]["w_up"].dtype == torch.bfloat16
        assert cp["dense_layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    # the bf16 LM's compute copy is its weights, not a second copy
    for path, w in held.weights.items():
        assert got[path].data_ptr() == w.data_ptr(), path


def test_serve_main_runs_deepseek_with_bf16_weights(capsys):
    fa.launches = 5
    res = tserve.main(["--arch", "deepseek-moe-16b", "--reduced", "--device",
                       "cpu", "--param-dtype", "bfloat16", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert res.tokens.shape == (2, 3)
    assert "deepseek-moe-16b on cpu, bfloat16 weights" in out
    assert "flash-attention kernel launches: 0" in out
    assert bool(torch.isfinite(res.last_logits.float()).all())


def test_generate_matches_teacher_forcing_without_drops():
    """In the port alone, float32, factor 16, bf16-held weights: the last
    decode logits of ``generate`` against a forward over prompt + generated
    tokens, 1e-4.  (In bf16 a near-tie at the k-th choice may route a
    token differently in decode and in the forward; chip_smoke.py records
    that for full-width deepseek-moe-16b and gates the float32 check.)"""
    _, tc = _cfgs("deepseek-moe-16b", moe_capacity_factor=16.0)
    lm = TT.LM.init(tc, seed=0, device="cpu", dtype=torch.bfloat16)
    prompts = tserve.make_prompts(tc, 2, 12, seed=4, device="cpu")
    res = tserve.generate(lm, prompts, gen=5)
    full = lm(torch.cat([prompts, res.tokens[:, :-1]], dim=1))
    _close(res.last_logits[:, 0], full[:, -1], 1e-4)
