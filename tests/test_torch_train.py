"""Port vs reference: the training path (``repro_torch.train``, ``data``).

The twins of ``tests/test_train.py``, and each piece held against the
reference on the same numpy inputs:
* ``lr_schedule`` at 1e-7; ``_q8`` / ``_dq8`` bit-identical;
* one ``adamw_update`` from the same bridged state for float32, bf16 and
  int8 state: params 1e-6, int8 ``q`` bit-identical;
* ``ef_compress`` at 1e-7; ``SyntheticSource`` batches bit-identical;
* ``lm_loss`` and its grads for reduced float32 tinyllama-1.1b, rwkv6-3b,
  olmo-1b and qwen1.5-32b against ``jax.value_and_grad`` of the
  reference's: loss 1e-5, grads 1e-4 (``tests/test_kernels.py:68``); the
  port's forward is the kernels' plain versions, its backward recomputes
  through ``blocked_attention`` / the chunk scan, the reference
  differentiates ``blocked_attention`` / its jnp scan: the same float32
  formulas summed in other orders;
* one ``make_train_step`` step (plain, 2 microbatches, int8 gradient
  compression): params 1e-5; with the batch's frame embeddings (reduced
  whisper-base) or patch embeddings (reduced phi-3-vision-4.2b), plain and
  in 2 microbatches: loss 1e-5, grad norm 1e-4, params 1e-5 wherever
  AdamW's first step is well-conditioned (``_close_step``);
* remat none / full / dots give the same grads, and full / dots run each
  layer's attention forward twice;
* checkpoints cross the two packages with identical keys and bit-identical
  arrays; torn ``.tmp`` folders are skipped; resume equals the
  uninterrupted run; the straggler watchdog; loss falls on structured data.
"""

import dataclasses
import os
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as j_make_step  # noqa: E402
from repro_torch import bridge, configs as tcfg  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.context import ModelContext  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_training  # noqa: E402
from repro_torch.train.train_step import (loss_and_grads,  # noqa: E402
                                          make_train_step)
from repro_torch.train.tree import flatten  # noqa: E402

STATE_DTYPES = ["float32", "bfloat16", "int8"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the small-tensor training tests: the suite
    runs six workers on eight cores, and torch's default thread pool per
    worker oversubscribes the cores; its spinning threads made a 60-step
    test take 210 s there against 5 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    over = {"dtype": "float32", **over}
    return (jcfg.reduced(jcfg.get_config(arch), **over),
            tcfg.reduced(tcfg.get_config(arch), **over))


def _jax_params(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  JT.init_lm(cfg, jax.random.PRNGKey(seed)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np_flat(tree):
    """{path: float32 numpy} of a reference tree (jax / numpy leaves)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t_flat(tree):
    return {path: (leaf.detach().float().numpy() if not isinstance(leaf, tuple)
                   else leaf)
            for path, leaf in flatten(tree)}


def _close_trees(port, ref, tol):
    p, r = _t_flat(port), _np_flat(ref)
    assert sorted(p) == sorted(r)
    for k in r:
        np.testing.assert_allclose(p[k], r[k], atol=tol, rtol=tol,
                                   err_msg=k)


def _batch(cfg, b=4, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# optimizer, compression, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr,warmup,total", [(1.0, 10, 100), (3e-4, 100,
                                                               10000)])
def test_lr_schedule_matches_reference(lr, warmup, total):
    jc = jopt.OptimizerConfig(lr=lr, warmup_steps=warmup, total_steps=total)
    tc = topt.OptimizerConfig(lr=lr, warmup_steps=warmup, total_steps=total)
    for s in (0, warmup // 2, warmup, (warmup + total) // 2, total,
              total + 7):
        ref = float(jopt.lr_schedule(jc, jnp.asarray(s)))
        out = topt.lr_schedule(tc, torch.tensor(s))
        assert out.dtype == torch.float32
        assert abs(out.item() - ref) <= 1e-7, (s, out.item(), ref)


def test_lr_schedule_shape():
    cfg = topt.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [topt.lr_schedule(cfg, torch.tensor(s)).item()
           for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0
    assert abs(lrs[4] - cfg.min_lr_ratio) < 1e-6


@pytest.mark.parametrize("shape", [(64, 384), (3, 200), (300,), (2, 5, 130),
                                   (128,)])
def test_q8_bit_identical_to_reference(shape):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32) * 3
    x.flat[0] = 0.0
    jq, js = jopt._q8(jnp.asarray(x))
    tq, ts = topt._q8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    jd = jopt._dq8(jq, js, shape)
    td = topt._dq8(tq, ts, shape)
    assert tuple(td.shape) == shape
    assert np.array_equal(td.numpy(), np.asarray(jd))


def test_q8_roundtrip_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 384)).astype(np.float32))
    q, s = topt._q8(x)
    y = topt._dq8(q, s, x.shape)
    assert float((x - y).abs().max() / x.abs().max()) < 0.02


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 256)).astype(np.float32),
            "b": rng.normal(size=(256,)).astype(np.float32),
            "small": rng.normal(size=(7,)).astype(np.float32),
            "layers": {"x": rng.normal(size=(2, 8, 130)).astype(np.float32),
                       "ln": {}}}


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_adamw_update_matches_reference_from_bridged_state(state_dtype):
    """One reference update makes a non-trivial state; it crosses the
    bridge, and both packages then take one update from it."""
    cfg_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10,
                  state_dtype=state_dtype, clip_norm=0.5)
    jc, tc = jopt.OptimizerConfig(**cfg_kw), topt.OptimizerConfig(**cfg_kw)
    params, g0, g1 = _opt_tree(0), _opt_tree(1), _opt_tree(2)
    jp, jst, _ = jopt.adamw_update(_jnp(g0), jopt.adamw_init(_jnp(params),
                                                               jc),
                                   _jnp(params), jc)
    st_np = jax.tree_util.tree_map(np.asarray, jst)
    tst = bridge.opt_state_from_numpy(st_np, device="cpu")
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    # the bridge is exact both ways
    back = bridge.opt_state_to_numpy(tst)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(back)),
                    jax.tree_util.tree_leaves(tuple(st_np))):
        assert np.array_equal(np.asarray(a), np.asarray(b, np.asarray(
            a).dtype))
    jp2, jst2, jm = jopt.adamw_update(_jnp(g1), jst, jp, jc)
    tp2, tst2, tm = topt.adamw_update(
        bridge.params_from_numpy(g1, device="cpu"), tst, tp, tc)
    _close_trees(tp2, jp2, 1e-6)
    assert int(tst2.step) == int(jst2.step) == 2
    assert abs(tm["lr"].item() - float(jm["lr"])) <= 1e-9
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-5
    ref_m = jax.tree_util.tree_map(np.asarray, jst2.m)
    for path, leaf in flatten(tst2.m):
        node = ref_m
        for key in path.split("/"):
            node = node[key]
        if state_dtype == "int8" and isinstance(leaf, tuple):
            assert np.array_equal(leaf[0].numpy(), node[0]), path
            np.testing.assert_allclose(leaf[1].numpy(), node[1], rtol=1e-6)
        else:
            assert leaf.dtype == (torch.bfloat16 if state_dtype == "bfloat16"
                                  else torch.float32)
            np.testing.assert_allclose(leaf.float().numpy(),
                                       np.asarray(node, np.float32),
                                       atol=1e-6, rtol=1e-2
                                       if state_dtype == "bfloat16" else 1e-6)


def test_adamw_converges_quadratic():
    cfg = topt.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=500,
                               weight_decay=0.0, clip_norm=0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.adamw_init(params, cfg)
    for _ in range(300):
        params, state, _ = topt.adamw_update({"w": 2 * params["w"]}, state,
                                             params, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_int8_optimizer_state_trains():
    cfg = topt.OptimizerConfig(lr=0.01, warmup_steps=0, weight_decay=0.0,
                               clip_norm=0, state_dtype="int8")
    params = {"w": torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 256)).astype(np.float32))}
    state = topt.adamw_init(params, cfg)
    assert isinstance(state.m["w"], tuple)
    target = torch.ones_like(params["w"])
    err0 = float((params["w"] - target).abs().mean())
    for _ in range(200):
        params, state, _ = topt.adamw_update(
            {"w": params["w"] - target}, state, params, cfg)
    err = float((params["w"] - target).abs().mean())
    assert err < err0 * 0.6, f"{err0:.3f} -> {err:.3f}"


def test_ef_compress_matches_reference():
    grads, ef = _opt_tree(3), _opt_tree(4)
    ef = jax.tree_util.tree_map(lambda x: x * 0.01, ef)
    jg, je = jcomp.ef_compress(_jnp(grads), _jnp(ef))
    tg, te = tcomp.ef_compress(bridge.params_from_numpy(grads, device="cpu"),
                               bridge.params_from_numpy(ef, device="cpu"))
    _close_trees(tg, jg, 1e-7)
    _close_trees(te, je, 1e-7)
    assert tcomp.ef_compress(tg, None) == (tg, None)
    init = tcomp.ef_init(bridge.params_from_numpy(grads, device="cpu"))
    _close_trees(init, jcomp.ef_init(_jnp(grads)), 0)


def test_error_feedback_unbiased():
    g_true = torch.from_numpy(np.random.default_rng(2).normal(
        size=(8, 256)).astype(np.float32))
    ef = tcomp.ef_init({"w": torch.zeros(8, 256)})
    acc = torch.zeros(8, 256)
    for _ in range(50):
        g, ef = tcomp.ef_compress({"w": g_true}, ef)
        acc = acc + g["w"]
    rel = float((acc - 50 * g_true).abs().max() / (50 * g_true).abs().max())
    assert rel < 0.02


@pytest.mark.parametrize("vocab,seq,batch,seed,ngram", [
    (32000, 2048, 4, 0, 8), (64, 33, 3, 5, 8), (256, 64, 2, 12345, 4)])
def test_synthetic_batches_bit_identical(vocab, seq, batch, seed, ngram):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed,
              ngram=ngram)
    jsrc = jpipe.SyntheticSource(jpipe.DataConfig(**kw))
    tsrc = tpipe.SyntheticSource(tpipe.DataConfig(**kw))
    for step in (0, 1, 7, 10 ** 6):
        a, b = jsrc.batch(step), tsrc.batch(step)
        for name in ("tokens", "labels"):
            assert a[name].dtype == b[name].dtype == np.int32
            assert np.array_equal(a[name], b[name]), (step, name)


def test_prefetcher_yields_in_order_and_stops():
    src = tpipe.SyntheticSource(tpipe.DataConfig(64, 16, 2))
    with tpipe.Prefetcher(src, start_step=3) as pf:
        got = [next(pf) for _ in range(5)]
    assert [s for s, _ in got] == [3, 4, 5, 6, 7]
    assert np.array_equal(got[2][1]["tokens"], src.batch(5)["tokens"])
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# loss and grads against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", [("tinyllama-1.1b", 24),
                                    ("rwkv6-3b", 32), ("olmo-1b", 24),
                                    ("qwen1.5-32b", 24),
                                    ("nemotron-4-340b", 24)])
def test_lm_loss_and_grads_match_reference(arch, s):
    jc, tc = _cfgs(arch)
    npp = _jax_params(jc)
    batch = _batch(jc, b=2, s=s, seed=1)

    def jloss(p):
        return JT.lm_loss(p, jc, jnp.asarray(batch["tokens"]),
                          jnp.asarray(batch["labels"]))
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(_jnp(npp))
    params = bridge.params_from_numpy(npp, device="cpu")
    loss, grads = loss_and_grads(tc, params, torch.from_numpy(
        batch["tokens"]).long(), torch.from_numpy(batch["labels"]))
    assert abs(loss.item() - float(jl)) <= 1e-5
    _close_trees(grads, jg, 1e-4)
    tl, aux = TT.lm_loss(params, tc, torch.from_numpy(batch["tokens"]),
                         torch.from_numpy(batch["labels"]))
    assert set(aux) == {"nll", "aux"} and aux["aux"].item() == 0.0
    assert abs(aux["nll"].item() - float(jaux["nll"])) <= 1e-5


def test_a_detached_master_is_refused():
    """A leaf the loss does not reach (a cut graph) raises, never trains
    silently."""
    _, tc = _cfgs("tinyllama-1.1b")
    params = TT.init_lm(tc, 0, device="cpu")
    params["unused"] = torch.zeros(3)
    batch = _batch(tc, b=1, s=8)
    with pytest.raises(RuntimeError, match="not have been used"):
        loss_and_grads(tc, params, torch.from_numpy(batch["tokens"]),
                       torch.from_numpy(batch["labels"]))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro,compress", [(1, False), (2, False),
                                            (1, True)],
                         ids=["plain", "microbatches-2", "compression"])
def test_train_step_matches_reference(micro, compress):
    jc, tc = _cfgs("tinyllama-1.1b")
    npp = _jax_params(jc)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jo, to = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    batch = _batch(jc, seed=2)
    jp = _jnp(npp)
    jstep = jax.jit(j_make_step(jc, jo, microbatches=micro,
                                grad_compression=compress))
    jp2, _, je2, jm = jstep(jp, jopt.adamw_init(jp, jo),
                            jcomp.ef_init(jp) if compress else None, batch)
    params = bridge.params_from_numpy(npp, device="cpu")
    tstep = make_train_step(tc, to, microbatches=micro,
                            grad_compression=compress)
    tp2, tst2, te2, tm = tstep(params, topt.adamw_init(params, to),
                               tcomp.ef_init(params) if compress else None,
                               batch)
    assert set(tm) == {"loss", "lr", "grad_norm"}
    assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-5
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4
    _close_trees(tp2, jp2, 1e-5)
    assert int(tst2.step) == 1
    assert (te2 is None) == (not compress)


def _frontend_extras(cfg, b, s, fill):
    """The reference's batch extras (``tests/test_models_smoke.py:21-29``):
    patch embeddings (B, num_patches, D) for a "patch" frontend, frame
    embeddings (B, S, D) for "frames", none without a frontend; ``fill``
    "0.01" as there, or "normal", seeded normals."""
    if cfg.frontend is None:
        return {}
    shape = {"patch": (b, cfg.num_patches, cfg.d_model),
             "frames": (b, s, cfg.d_model)}[cfg.frontend]
    name = "patch_embeds" if cfg.frontend == "patch" else "frame_embeds"
    if fill == "0.01":
        return {name: np.full(shape, 0.01, np.float32)}
    return {name: np.random.default_rng(3).normal(size=shape).astype(
        np.float32)}


def _close_step(port, ref, port_grads, ref_grads, lr, tol=1e-5, eps=1e-8,
                clip_norm=1.0):
    """One AdamW step, port against reference: every grad at 1e-4 (the
    port's grad tolerance, ``test_lm_loss_and_grads_match_reference``),
    then the params after the step at ``tol`` on every element whose
    reference grad, clipped to the global norm ``clip_norm`` as the step
    clips it, is 0 or at least 100 x ``eps``.  The first step moves a
    param by lr · g / (|g| + eps) (plus the same weight decay in both):
    where |g| is near eps, a float32 summation-order difference of 1e-9 in
    the grad moves the update by up to a few percent of lr (reduced
    whisper-base on normal frames: a grad of 1.51e-8 in the reference,
    1.24e-8 in the port; qwen's key bias, whose grad RoPE alone keeps from
    0).  Those elements, at most 1% of the parameters, are held at 2 · lr,
    the most two updates of size <= lr can differ, beside their grads."""
    _close_trees(port_grads, ref_grads, 1e-4)
    p, r, g = _t_flat(port), _np_flat(ref), _np_flat(ref_grads)
    assert sorted(p) == sorted(r) == sorted(g)
    norm = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                       for v in g.values()))
    clip = min(1.0, clip_norm / (norm + 1e-9))
    blunt = 0
    for k in r:
        sharp = (np.abs(g[k]) * clip >= 100 * eps) | (g[k] == 0)
        blunt += int((~sharp).sum())
        np.testing.assert_allclose(p[k][sharp], r[k][sharp], atol=tol,
                                   rtol=tol, err_msg=k)
        assert (np.abs(p[k] - r[k])[~sharp] <= 2 * lr + tol).all(), k
    assert blunt <= 0.01 * sum(v.size for v in r.values()), blunt


def _step_grads(jc, tc, npp, batch):
    """Both packages' grads of ``lm_loss`` on the whole ``batch`` (its
    frontend inputs too), from the same params: (port, reference)."""
    ex = {n: batch[n] for n in batch if n.endswith("_embeds")}
    jg = jax.grad(lambda p: JT.lm_loss(
        p, jc, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
        **{n: jnp.asarray(v) for n, v in ex.items()})[0])(_jnp(npp))
    _, tg = loss_and_grads(
        tc, bridge.params_from_numpy(npp, device="cpu"),
        torch.as_tensor(batch["tokens"]).long(),
        torch.as_tensor(batch["labels"]).long(),
        **{n: torch.as_tensor(v) for n, v in ex.items()})
    return tg, jg


@pytest.mark.parametrize("fill", ["0.01", "normal"])
@pytest.mark.parametrize("micro", [1, 2], ids=["plain", "microbatches-2"])
@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_train_step_matches_reference_with_batch_extras(arch, micro, fill):
    """The batch's frontend inputs reach the loss, split with the tokens
    into microbatches, as the reference's ``_batch_extras`` /
    ``accum_grads`` pass them (``train_step.py:28-34, 71-73``); the
    tolerances of ``test_train_step_matches_reference``."""
    jc, tc = _cfgs(arch)
    npp = _jax_params(jc)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jo, to = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    batch = {**_batch(jc, s=32, seed=2),
             **_frontend_extras(jc, 4, 32, fill)}
    jp = _jnp(npp)
    jp2, _, _, jm = jax.jit(j_make_step(jc, jo, microbatches=micro))(
        jp, jopt.adamw_init(jp, jo), None, batch)
    params = bridge.params_from_numpy(npp, device="cpu")
    tp2, _, _, tm = make_train_step(tc, to, microbatches=micro)(
        params, topt.adamw_init(params, to), None, batch)
    assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-5
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4
    _close_step(tp2, jp2, *_step_grads(jc, tc, npp, batch),
                float(jm["lr"]))


def test_grad_accumulation_matches_full_batch():
    _, tc = _cfgs("tinyllama-1.1b")
    params = TT.init_lm(tc, 0, device="cpu")
    opt = topt.OptimizerConfig(lr=0.0, warmup_steps=0)
    batch = _batch(tc, s=32)
    m1 = make_train_step(tc, opt, microbatches=1)(
        params, topt.adamw_init(params, opt), None, batch)[3]
    m2 = make_train_step(tc, opt, microbatches=2)(
        params, topt.adamw_init(params, opt), None, batch)[3]
    assert abs(m1["loss"].item() - m2["loss"].item()) < 1e-3
    assert abs(m1["grad_norm"].item() - m2["grad_norm"].item()) < 2e-2


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_remat_policies_give_the_same_grads(arch, monkeypatch):
    _, tc = _cfgs(arch)
    params = TT.init_lm(tc, 0, device="cpu")
    batch = _batch(tc, b=2, s=32)
    toks, labels = (torch.from_numpy(batch[n]) for n in ("tokens", "labels"))
    name = "flash_attention_plain" if arch != "rwkv6-3b" else \
        "rwkv6_fused_plain"
    plain, calls = getattr(ops, name), []
    monkeypatch.setattr(ops, name,
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    out = {}
    for remat in ("none", "full", "dots"):
        calls.clear()
        out[remat] = loss_and_grads(tc, params, toks, labels,
                                    ctx=ModelContext(remat=remat))
        runs = 1 if remat == "none" else 2   # the recompute runs it again
        assert len(calls) == runs * tc.num_layers, (remat, len(calls))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for (path, a), (_, b) in zip(flatten(out[remat][1]),
                                     flatten(out["none"][1])):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6,
                                       msg=f"{remat} {path}")


def test_remat_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="remat"):
        ModelContext(remat="some").maybe_remat(len)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trained_state(state_dtype):
    """Reduced float32 olmo-1b (empty nonparam_ln subtrees) after one
    reference update: (reference cfg, params, opt state) as numpy, and the
    port's twins."""
    jc = jcfg.reduced(jcfg.get_config("olmo-1b"), dtype="float32",
                      num_layers=1)
    tc = tcfg.reduced(tcfg.get_config("olmo-1b"), dtype="float32",
                      num_layers=1)
    npp = _jax_params(jc)
    jo = jopt.OptimizerConfig(state_dtype=state_dtype, warmup_steps=0)
    jp, jst, _ = jopt.adamw_update(
        jax.tree_util.tree_map(lambda x: jnp.asarray(x) * 0.1, npp),
        jopt.adamw_init(_jnp(npp), jo), _jnp(npp), jo)
    jp, jst = (jax.tree_util.tree_map(np.asarray, x) for x in (jp, jst))
    return (jc, jp, jst, tc, bridge.params_from_numpy(jp, device="cpu"),
            bridge.opt_state_from_numpy(jst, device="cpu"))


def _npz(cdir, step):
    with np.load(os.path.join(cdir, f"step_{step:08d}", "arrays.npz")) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_checkpoint_crosses_packages(tmp_path, state_dtype):
    """Port -> reference and reference -> port: identical keys,
    bit-identical arrays, and each package restores the other's.  A bf16
    leaf is written by the port as float32 (exact; the reference restores it
    into bf16) and the reference's ml_dtypes bf16 array is restored by the
    port from its bits."""
    jc, jp, jst, tc, tp, tst = _trained_state(state_dtype)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    tckpt.save(pdir, 3, tp, tst, extra={"who": "port"})
    jckpt.save(jdir, 3, _jnp(jp), jst, extra={"who": "ref"})
    a, b = _npz(pdir, 3), _npz(jdir, 3)
    assert sorted(a) == sorted(b)
    assert "opt/.step" in a and not any("ln1" in k for k in a)
    for k in a:
        want = b[k]
        if want.dtype.kind == "V":            # ml_dtypes bf16, by its bits
            want = torch.from_numpy(want.view(np.int16)).view(
                torch.bfloat16).float().numpy()
        assert a[k].dtype == want.dtype and np.array_equal(a[k], want), k
    # the reference restores the port's checkpoint
    jtemplate = jopt.adamw_init(_jnp(jp), jopt.OptimizerConfig(
        state_dtype=state_dtype))
    rp, ro, meta = jckpt.restore(pdir, 3, _jnp(jp), jtemplate)
    assert meta == {"step": 3, "extra": {"who": "port"}}
    for x, y in zip(jax.tree_util.tree_leaves((rp, ro)),
                    jax.tree_util.tree_leaves((jp, jst))):
        assert x.dtype == y.dtype and np.array_equal(np.asarray(x), y)
    # the port restores the reference's
    ttemplate = topt.adamw_init(tp, topt.OptimizerConfig(
        state_dtype=state_dtype))
    pp, po, meta = tckpt.restore(jdir, 3, tp, ttemplate)
    assert meta["extra"] == {"who": "ref"}
    assert pp["layers"]["ln1"] == {} and pp["ln_f"] == {}
    for (k, x), (_, y) in zip(flatten(pp), flatten(tp)):
        assert torch.equal(x, y), k
    assert int(po.step) == 1
    for tree, want in ((po.m, tst.m), (po.v, tst.v)):
        for (k, x), (_, y) in zip(flatten(tree), flatten(want)):
            for xx, yy in zip(x if isinstance(x, tuple) else (x,),
                              y if isinstance(y, tuple) else (y,)):
                assert xx.dtype == yy.dtype and torch.equal(xx, yy), k


def test_torn_checkpoint_skipped(tmp_path):
    _, _, _, _, tp, tst = _trained_state("float32")
    cdir = str(tmp_path / "ck")
    tckpt.save(cdir, 5, tp, tst)
    os.makedirs(os.path.join(cdir, "step_00000010.tmp"))
    assert tckpt.latest_step(cdir) == 5
    restored = tckpt.restore_latest(cdir, tp, tst)
    assert restored is not None and restored[0] == 5
    assert tckpt.restore_latest(str(tmp_path / "none"), tp) is None


def test_checkpoint_roundtrip_exact_and_gc(tmp_path):
    _, _, _, _, tp, tst = _trained_state("int8")
    cdir = str(tmp_path / "ck")
    for step in (1, 2, 3, 4):
        tckpt.save(cdir, step, tp, tst)
    tckpt.gc_old(cdir, keep=2)
    assert sorted(os.listdir(cdir)) == ["step_00000003", "step_00000004"]
    p2, o2, meta = tckpt.restore(cdir, 4, tp, tst)
    assert meta["step"] == 4
    for (_, a), (_, b) in zip(flatten(p2), flatten(tp)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="ckpt"):
        tckpt.restore(cdir, 4, {**tp, "embed": tp["embed"][:1]})


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _small(arch="olmo-1b", **over):
    kw = dict(num_layers=2, d_model=64, vocab_size=64, d_ff=128)
    kw.update(over)
    return tcfg.reduced(tcfg.get_config(arch), dtype="float32", **kw)


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-3b"])
def test_resume_equals_the_uninterrupted_run(tmp_path, arch):
    cfg = _small(arch)
    opt = topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    data = tpipe.DataConfig(vocab_size=64, seq_len=32, global_batch=4)
    step = make_train_step(cfg, opt)
    quiet = dict(log=lambda s: None)
    full = run_training(cfg, step, TT.init_lm(cfg, 0, device="cpu"), opt,
                        data, LoopConfig(total_steps=6, ckpt_every=0,
                                         log_every=0), **quiet)
    cdir = str(tmp_path / "ck")
    r1 = run_training(cfg, step, TT.init_lm(cfg, 0, device="cpu"), opt, data,
                      LoopConfig(total_steps=3, ckpt_every=3, ckpt_dir=cdir,
                                 log_every=0), **quiet)
    assert tckpt.latest_step(cdir) == 3 and r1.resumed_from is None
    r2 = run_training(cfg, step, TT.init_lm(cfg, 1, device="cpu"), opt, data,
                      LoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=cdir,
                                 log_every=0), **quiet)
    assert r2.resumed_from == 3 and r2.steps_run == 6
    assert r1.losses + r2.losses == full.losses       # bit-exact on the CPU
    assert len(full.grad_norms) == 6


def test_training_resumes_from_checkpoint(tmp_path):
    cfg = _small()
    opt = topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    data = tpipe.DataConfig(vocab_size=64, seq_len=32, global_batch=4)
    step = make_train_step(cfg, opt)
    cdir = str(tmp_path / "ck")
    params = TT.init_lm(cfg, 0, device="cpu")
    run_training(cfg, step, params, opt, data,
                 LoopConfig(total_steps=10, ckpt_every=5, ckpt_dir=cdir,
                            log_every=0), log=lambda s: None)
    assert tckpt.latest_step(cdir) == 10
    r2 = run_training(cfg, step, params, opt, data,
                      LoopConfig(total_steps=20, ckpt_every=5, ckpt_dir=cdir,
                                 log_every=0), log=lambda s: None)
    assert r2.resumed_from == 10 and r2.steps_run == 20


def test_straggler_watchdog():
    """Inject one slow step; the loop must count it."""
    cfg = _small(num_layers=1, d_model=32, vocab_size=32, d_ff=64)
    opt = topt.OptimizerConfig()
    base = make_train_step(cfg, opt)
    took = []

    def slow_step(p, o, e, b):
        t0 = time.perf_counter()
        out = base(p, o, e, b)
        took.append(time.perf_counter() - t0)
        if len(took) == 12:     # well past 3x the median, on any host load
            time.sleep(max(1.0, 4 * max(took)))
        return out
    data = tpipe.DataConfig(vocab_size=32, seq_len=32, global_batch=4)
    logs = []
    rep = run_training(cfg, slow_step, TT.init_lm(cfg, 0, device="cpu"), opt,
                       data, LoopConfig(total_steps=16, ckpt_every=0,
                                        log_every=0), log=logs.append)
    assert rep.straggler_steps >= 1
    assert any("straggler at step 11" in line for line in logs)


def test_loss_decreases_on_structured_data():
    """End to end: a few dozen steps on learnable synthetic data."""
    cfg = tcfg.reduced(tcfg.get_config("tinyllama-1.1b"), num_layers=2,
                       d_model=128, vocab_size=64, d_ff=256,
                       dtype="float32")
    opt = topt.OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    data = tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                            global_batch=8, ngram=8)
    report = run_training(cfg, make_train_step(cfg, opt),
                          TT.init_lm(cfg, 0, device="cpu"), opt, data,
                          LoopConfig(total_steps=60, ckpt_every=0,
                                     log_every=0), log=lambda s: None)
    first, last = np.mean(report.losses[:5]), np.mean(report.losses[-5:])
    assert last < first - 0.3, f"no learning: {first:.3f} -> {last:.3f}"


def test_config_replace_keeps_training_path():
    """A bf16 config trains from float32 masters: grads stay float32."""
    _, tc = _cfgs("tinyllama-1.1b")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    params = TT.init_lm(tc, 0, device="cpu")
    batch = _batch(tc, b=2, s=16)
    loss, grads = loss_and_grads(tc, params, torch.from_numpy(
        batch["tokens"]), torch.from_numpy(batch["labels"]))
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    for path, g in flatten(grads):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), \
            path
