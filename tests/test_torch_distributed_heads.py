"""Port vs reference under a mesh where the tensor-parallel split does not
divide the heads: the production mesh's model axis of 16 over whisper-base's
8 heads, qwen1.5-32b's 40 and zamba2-2.7b's 40 SSM heads, here a model axis
of 4 over 6 or 2 heads.

Each rank keeps whole heads (``models/attention.py::whole_heads``), so the
heads' columns stay split over the mesh dims whose sizes divide the heads
and whole over the rest.  Two faults lived there: the attention's
out-projection took its grad split over every tp dim, and DTensor's rule
for the backward of the heads' merge unflattened it into half a head (or
2.5 heads) of columns; Mamba2's causal conv multiplied the whole-head
columns by its tp-split weight, which split them again before the heads'
reshape, in the train step, the prefill and decode alike.

One group of 4 spawned ranks on the CPU (``repro_torch.testing.run_ranks``)
computes every case; each test holds one against the reference, which runs
in this process on the same params (bridged) and batches.  Configs,
reduced and float32, on (data 1, model 4): tinyllama-1.1b with 6 query and
2 KV heads and with 2 and 2, qwen1.5-32b with 6 heads and its attention
biases, whisper-base with 2 heads (encoder, self and cross attention), and
zamba2-2.7b with 6 SSM heads (4 layers: two groups).  Tolerances: loss 1e-5
and every grad 1e-4 against ``jax.value_and_grad(lm_loss)``; for serving,
the prefill's and 3 decode steps' logits 1e-4 against the reference's
``prefill`` / ``decode_step``, and the greedy tokens equal.

zamba2 with sequence parallelism on and remat full is held in float64
(``repro_torch.testing.precision``): the sharded loss and grads equal the
single device's to 1e-10.  In float32 its embed grad sits 2.2e-4 from the
reference's on 2 of 24,576 elements, the rounding of random Mamba2 blocks
that ``tests/test_torch_distributed_ssm.py``'s rounding cases hold.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCHS = {
    "tinyllama-6q2kv": ("tinyllama-1.1b", dict(
        dtype="float32", num_heads=6, num_kv_heads=2, d_model=96)),
    "tinyllama-2q2kv": ("tinyllama-1.1b", dict(
        dtype="float32", num_heads=2, num_kv_heads=2, head_dim=32)),
    "qwen-6h-bias": ("qwen1.5-32b", dict(
        dtype="float32", num_heads=6, num_kv_heads=6, d_model=96)),
    "whisper-2h": ("whisper-base", dict(
        dtype="float32", num_heads=2, num_kv_heads=2, head_dim=32)),
    "zamba2-6ssm": ("zamba2-2.7b", dict(
        dtype="float32", num_layers=4, ssm_heads=6, d_model=96)),
}
MESH = (1, 4)
# (sequence_parallel, remat): every case runs the first; the attention and
# Mamba2 faults' archs the second too
GRAD_CASES = {name: [(False, "none")] for name in ARCHS}
GRAD_CASES["tinyllama-6q2kv"].append((True, "full"))
GRAD_CASES["zamba2-6ssm"].append((False, "full"))
ROUNDING = ("zamba2-6ssm", (True, "full"))
SERVE = ("tinyllama-6q2kv", "zamba2-6ssm")
BATCH, SEQ, FRAMES, TOKEN_SEED = 4, 16, 24, 1
MAX_LEN, STEPS = 24, 3


def _grad_params():
    return [(name, case) for name, cases in GRAD_CASES.items()
            for case in cases]


def _case_id(param):
    name, (sp, remat) = param
    return f"{name}-sp_{'on' if sp else 'off'}-remat_{remat}"


# ---------------------------------------------------------------------------
# the ranks' side (torch and the port only)
# ---------------------------------------------------------------------------

def _port_cfg(name):
    from repro_torch import configs
    arch, over = ARCHS[name]
    return configs.reduced(configs.get_config(arch), **over)


def _grads_case(cfg, params_np, batch, mesh, sp, remat,
                dtype=torch.float32):
    from repro_torch import bridge
    from repro_torch.configs import RunConfig
    from repro_torch.parallel.sharding import distribute_local, make_context
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.tree import flatten, tree_map
    ctx = make_context(mesh, cfg, RunConfig(remat=remat,
                                            sequence_parallel=sp))
    params = bridge.place_params(tree_map(
        lambda x: x.to(dtype), bridge.params_from_numpy(params_np,
                                                        device="cpu")),
        cfg, ctx.mesh)

    def rows(x):
        x = torch.as_tensor(x)
        x = x.to(dtype) if x.is_floating_point() else x
        return distribute_local(x.long() if x.dtype == torch.int32 else x,
                                ctx.dmesh, ctx.placements(
                                    "dp", *[None] * (x.dim() - 1)))
    extras = {n: rows(batch[n]) for n in ("frame_embeds",) if n in batch}
    loss, grads = loss_and_grads(cfg, params, rows(batch["tokens"]),
                                 rows(batch["labels"]), ctx=ctx, **extras)
    return {"loss": float(loss.full_tensor()),
            "grads": {p: g.full_tensor().detach().numpy()
                      for p, g in flatten(grads)},
            "view": tuple(ctx.mesh.mesh.shape)}


def _serve_case(cfg, params_np, case, mesh):
    from repro_torch import bridge
    from repro_torch.configs import RunConfig
    from repro_torch.parallel.sharding import make_context
    from repro_torch.serve.decode import decode_step, greedy, prefill
    ctx = make_context(mesh, cfg, RunConfig())
    params = bridge.place_params(bridge.params_from_numpy(
        params_np, device="cpu"), cfg, ctx.mesh)
    with torch.no_grad():
        logits, state = prefill(params, cfg, torch.as_tensor(case["tokens"]),
                                MAX_LEN, ctx=ctx)
        out, tokens = [logits.full_tensor().numpy()], []
        for nxt in case["feed"]:
            tokens.append(greedy(logits, ctx).full_tensor().numpy())
            logits, state = decode_step(params, cfg, torch.as_tensor(nxt),
                                        state, ctx=ctx)
            out.append(logits.full_tensor().numpy())
    return {"logits": out, "greedy": tokens,
            "view": tuple(ctx.mesh.mesh.shape)}


def _rank_all(rank, world, payload):
    import logging

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.testing import gloo_cuda
    gloo_cuda.use_c10d_collectives()
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    mesh = make_smoke_mesh(MESH, device="cpu")
    out = {"grads": {}, "serve": {}}
    for name, case in _grad_params():
        out["grads"][(name, case)] = _grads_case(
            _port_cfg(name), payload["params"][name],
            payload["batch"][name], mesh, *case)
    from repro_torch.testing.precision import float64_compute
    name, case = ROUNDING
    with float64_compute():
        out["rounding"] = _grads_case(
            _port_cfg(name), payload["params"][name],
            payload["batch"][name], mesh, *case, dtype=torch.float64)
    for name in SERVE:
        out["serve"][name] = _serve_case(_port_cfg(name),
                                         payload["params"][name],
                                         payload["serve"][name], mesh)
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _ref_cfg(name):
    from repro import configs as jcfg
    arch, over = ARCHS[name]
    return jcfg.reduced(jcfg.get_config(arch), **over)


def _np_flat(tree):
    jax, _ = _jax()
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg):
    rng = np.random.default_rng(TOKEN_SEED)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "frames":
        out["frame_embeds"] = rng.normal(
            size=(BATCH, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _serve_reference(cfg, params_np, tokens):
    """The reference's prefill and decode steps, each step fed its own
    greedy token: (logits of the prefill and each step, the tokens fed)."""
    jax, jnp = _jax()
    from repro.serve import decode as JD
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    logits, state = JD.prefill(params, cfg, jnp.asarray(tokens, jnp.int32),
                               MAX_LEN)
    out, feed = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int64)
        feed.append(tok)
        logits, state = JD.decode_step(params, cfg,
                                       jnp.asarray(tok, jnp.int32), state)
        out.append(np.asarray(logits))
    return out, feed


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    jax, _ = _jax()
    from repro.models import transformer as JT
    from repro_torch.testing import run_ranks
    tmp = tmp_path_factory.mktemp("dist-heads")
    cfgs = {name: _ref_cfg(name) for name in ARCHS}
    payload = {"params": {name: jax.tree_util.tree_map(
        np.asarray, JT.init_lm(c, jax.random.PRNGKey(0)))
        for name, c in cfgs.items()},
        "batch": {name: _batch(c) for name, c in cfgs.items()},
        "serve": {}}
    want = {}
    for name in SERVE:
        tokens = np.random.default_rng(3).integers(
            0, cfgs[name].vocab_size, (BATCH, SEQ))
        want[name], feed = _serve_reference(cfgs[name],
                                            payload["params"][name], tokens)
        payload["serve"][name] = {"tokens": tokens, "feed": feed}
    out = run_ranks(_rank_all, 4, (payload,), workdir=tmp, timeout=600)[0]
    return payload, want, out


_REFERENCE = {}


def _reference(payload, name):
    """The reference's loss and grads of ``lm_loss`` on one device."""
    if name not in _REFERENCE:
        jax, jnp = _jax()
        from repro.models import transformer as JT
        cfg = _ref_cfg(name)
        b = payload["batch"][name]
        extras = {n: jnp.asarray(b[n]) for n in ("frame_embeds",) if n in b}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JT.lm_loss(p, cfg, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["labels"]), **extras)[0]))(
            jax.tree_util.tree_map(jnp.asarray, payload["params"][name]))
        _REFERENCE[name] = (float(loss), _np_flat(grads))
    return _REFERENCE[name]


@pytest.mark.parametrize("param", _grad_params(), ids=_case_id)
def test_uneven_heads_grads_match_reference(group, param):
    """Loss 1e-5 and every grad 1e-4 against ``jax.value_and_grad``, with
    the model axis of 4 split into a view whose tp dims do not all divide
    the heads."""
    payload, _, out = group
    name, _ = param
    got = out["grads"][param]
    assert got["view"][0] == MESH[0]
    assert got["view"][1] * got["view"][2] == MESH[1]
    loss, want = _reference(payload, name)
    assert abs(got["loss"] - loss) <= 1e-5
    assert sorted(got["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got["grads"][k], g, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_uneven_ssm_heads_float64_equals_single_device(group):
    """zamba2 with 6 SSM heads, sequence parallelism on and remat full, in
    float64: the sharded loss and every grad equal the port's single
    device's to 1e-10, so the sharded path computes the same function."""
    from repro_torch import bridge
    from repro_torch.testing.precision import float64_compute
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.tree import flatten, tree_map
    payload, _, out = group
    name, _ = ROUNDING
    b = payload["batch"][name]
    params = tree_map(lambda x: x.to(torch.float64), bridge.params_from_numpy(
        payload["params"][name], device="cpu"))
    with float64_compute():
        loss, grads = loss_and_grads(
            _port_cfg(name), params, *(torch.as_tensor(b[n]).long()
                                       for n in ("tokens", "labels")))
    got = out["rounding"]
    assert abs(got["loss"] - float(loss)) <= 1e-10
    want = {p: g.numpy() for p, g in flatten(grads)}
    assert sorted(got["grads"]) == sorted(want)
    for k, w in want.items():
        assert got["grads"][k].dtype == np.float64, k
        np.testing.assert_allclose(got["grads"][k], w, atol=1e-10,
                                   rtol=1e-10, err_msg=k)


@pytest.mark.parametrize("name", SERVE)
def test_uneven_heads_prefill_and_decode_match_reference(group, name):
    """The prefill's last logits and 3 decode steps' logits within 1e-4 of
    the reference's; the greedy tokens from the vocab-split logits equal
    the reference's argmax."""
    payload, want, out = group
    got = out["serve"][name]
    assert len(got["logits"]) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["logits"], want[name])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} step {i}")
    for g, w in zip(got["greedy"], payload["serve"][name]["feed"]):
        np.testing.assert_array_equal(g, w)
