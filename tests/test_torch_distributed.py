"""Port vs reference under a mesh: the twins of ``tests/test_distributed.py``.

Rank groups are spawned processes on the CPU (``repro_torch.testing.
run_ranks``): the ``gloo`` backend, a ``FileStore`` rendezvous under the
test's ``tmp_path`` (no TCP port, so xdist workers never collide), and a
deadline of each group's own, so a hung rank fails its test instead of the
suite.  The
reference's side (JAX, one device) runs in this process on the same
params (bridged) and batches; the ranks import only torch and the port.

One group of 4 ranks computes every case of the sharded train step (one
config whose leaves are all under FSDP's size threshold, one whose larger
leaves also shard over "data"), the KV-heads-fewer-than-TP forward, both
expert-parallel layouts (forward, loss and grads) and the elastic restore
(module fixture ``group``); each test then holds one case against the
reference.  Tolerances: loss 1e-5 and grads 1e-4 against the reference's
``jax.value_and_grad``; params after one AdamW step (lr 1e-3) 1e-5 against
the port's own single-device step (in the FSDP case, elements whose grad
is near AdamW's eps at 2 · lr, as ``tests/test_torch_train.py::
_close_step`` holds them), and at the reference's lr 1e-2 its own
criterion (fewer than 1% of entries off by more than 5e-3 from the
reference's step); forward 1e-5 (dense) and 1e-4 (MoE, float32, nothing
dropped); the MoE aux 1e-6 against the mean of the reference's aux over
each rank's token slice, and the MoE loss and grads (1e-5 / 1e-4) against
the reference's value_and_grad of the same loss (its nll plus 0.01 x that
mean); checkpoints exact.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TRAIN_CASES = [  # (microbatches, remat, sequence_parallel, compression)
    (mb, remat, sp, False) for mb in (1, 2) for remat in ("none", "full")
    for sp in (False, True)] + [(1, "none", False, True)]
GRAD_CASES = [(remat, sp) for remat in ("none", "full") for sp in (False,
                                                                  True)]
# AdamW's first step moves each entry by about lr·g / (|g| + eps), so an
# entry whose grad sums to near zero moves by up to lr times a difference of
# reduction order: the 1e-5 comparison runs at lr 1e-3, as the port's
# single-device step test does (tests/test_torch_train.py), the
# reference's own criterion at its lr 1e-2 (tests/test_distributed.py)
LR = 1e-3
REF_LR = 1e-2
FSDP_MICROBATCHES = (1, 2)


def _case_id(case):
    mb, remat, sp, gc = case
    return f"mb{mb}-remat_{remat}-sp_{'on' if sp else 'off'}" + (
        "-compression" if gc else "")


# ---------------------------------------------------------------------------
# rank groups
# ---------------------------------------------------------------------------

def spawn_group(world, fn, payload, tmp_path, timeout):
    """Rank 0's result of ``fn(rank, world, payload)`` on ``world`` spawned
    ranks (``repro_torch.testing.run_ranks``: gloo, a FileStore under
    ``tmp_path``, the group's own deadline)."""
    from repro_torch.testing import run_ranks
    return run_ranks(fn, world, (payload,), workdir=tmp_path,
                     timeout=timeout)[0]


# ---------------------------------------------------------------------------
# the ranks' side (torch and the port only)
# ---------------------------------------------------------------------------

def _dense_cfg():
    from repro_torch import configs
    return configs.reduced(configs.get_config("tinyllama-1.1b"),
                           num_layers=2, num_heads=4, num_kv_heads=2,
                           d_model=64, head_dim=16, vocab_size=256,
                           d_ff=128, dtype="float32")


def _moe_cfg(experts):
    from repro_torch import configs
    return configs.reduced(configs.get_config("deepseek-moe-16b"),
                           num_layers=2, num_heads=4, num_kv_heads=4,
                           d_model=64, head_dim=16, vocab_size=128,
                           moe_num_experts=experts, moe_top_k=2,
                           moe_d_ff=32, moe_first_dense=1,
                           moe_capacity_factor=8.0, dtype="float32")


# FSDP shards a leaf of 1 << 16 entries or more over "data"
# (launch.dryrun._fsdp_spec): vocab 1024 and d_ff 512 make the embedding,
# the head and the MLP's matrices such leaves
FSDP_KW = dict(vocab_size=1024, d_ff=512)
FSDP_LEAVES = ("embed", "lm_head", "layers/mlp/w_up", "layers/mlp/w_gate",
               "layers/mlp/w_down")
OLMO_KW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
               head_dim=16, vocab_size=256, d_ff=128)
ELASTIC = {"tp": {}, "fsdp": FSDP_KW}


def _olmo_cfg(**over):
    from repro_torch import configs
    return configs.reduced(configs.get_config("olmo-1b"),
                           **{**OLMO_KW, **over})


def _fsdp_cfg():
    from repro_torch import configs
    return configs.reduced(configs.get_config("tinyllama-1.1b"),
                           **{**DENSE_KW, **FSDP_KW})


def _data_sharded(tree):
    """Paths of the DTensor leaves split over the mesh's "data" dim."""
    from repro_torch.train.tree import flatten
    out = []
    for p, x in flatten(tree):
        names = x.device_mesh.mesh_dim_names
        if "data" in names and type(
                x.placements[names.index("data")]).__name__ == "Shard":
            out.append(p)
    return out


def _full(tree):
    """{path: numpy} of a tree of DTensors (a collective on every rank)."""
    from repro_torch.train.tree import flatten
    return {p: x.full_tensor().detach().numpy() for p, x in flatten(tree)}


def _rank_all(rank, world, payload):
    import logging

    from repro_torch import bridge
    from repro_torch.configs import RunConfig
    from repro_torch.launch.dryrun import sharded_param_specs
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import (abstract_params,
                                               distribute_local, make_context)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.compression import ef_init
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.testing import gloo_cuda
    from repro_torch.train.tree import flatten, leaves
    # the CUDA-only collective kernels leave the CPU path as it is
    gloo_cuda.use_c10d_collectives()
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    out = {"train": {}, "grads": {}}
    cfg = _dense_cfg()
    mesh22 = make_smoke_mesh((2, 2), device="cpu")
    mesh14 = make_smoke_mesh((1, 4), device="cpu")
    opt_cfg = OptimizerConfig(lr=LR, warmup_steps=0)
    ref_opt = OptimizerConfig(lr=REF_LR, warmup_steps=0)
    batch = payload["batch"]
    # FSDP: one step of the config whose larger leaves shard over "data"
    out["fsdp"] = {}
    fcfg = _fsdp_cfg()
    for mb in FSDP_MICROBATCHES:
        ctx = make_context(mesh22, fcfg, RunConfig(remat="none"))
        params = bridge.place_params(bridge.params_from_numpy(
            payload["fsdp"], device="cpu"), fcfg, ctx.mesh)
        step = make_train_step(fcfg, opt_cfg, ctx=ctx, microbatches=mb)
        p2, st2, _, m = step(params, adamw_init(params, opt_cfg), None,
                             payload["fsdp_batch"])
        out["fsdp"][mb] = {
            "params": _full(p2), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "data_sharded": _data_sharded(p2),
            "moments_sharded": _data_sharded(st2.m)}
    ctxs = {}
    for mb, remat, sp, gc in TRAIN_CASES:
        key = (remat, sp)
        if key not in ctxs:
            ctxs[key] = make_context(mesh22, cfg, RunConfig(
                remat=remat, sequence_parallel=sp))
        ctx = ctxs[key]
        params = bridge.place_params(bridge.params_from_numpy(
            payload["dense"], device="cpu"), cfg, ctx.mesh)
        got = {}
        for name, oc in (("params", opt_cfg), ("params_ref_lr", ref_opt)):
            step = make_train_step(cfg, oc, ctx=ctx, microbatches=mb,
                                   grad_compression=gc)
            p2, st2, ef2, m = step(params, adamw_init(params, oc),
                                   ef_init(params) if gc else None, batch)
            got[name] = _full(p2)
        out["train"][(mb, remat, sp, gc)] = {
            **got, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "step": int(st2.step),
            "placements": {p: str(x.placements) for p, x in flatten(p2)}}
    for remat, sp in GRAD_CASES:
        ctx = ctxs[(remat, sp)]
        params = bridge.place_params(bridge.params_from_numpy(
            payload["dense"], device="cpu"), cfg, ctx.mesh)
        rows = ctx.placements("dp", None)
        tok, lab = (distribute_local(torch.as_tensor(batch[n]).long(),
                                     ctx.dmesh, rows)
                    for n in ("tokens", "labels"))
        loss, grads = loss_and_grads(cfg, params, tok, lab, ctx=ctx)
        out["grads"][(remat, sp)] = {"loss": float(loss.full_tensor()),
                                     "grads": _full(grads)}
    # KV heads fewer than TP: 4 / 2 heads on (1, 4)
    ctx = make_context(mesh14, cfg, RunConfig(remat="none"))
    params = bridge.place_params(bridge.params_from_numpy(
        payload["dense"], device="cpu"), cfg, ctx.mesh)
    toks = distribute_local(torch.as_tensor(batch["tokens"]).long(),
                            ctx.dmesh, ctx.placements("dp", None))
    logits, _ = T.forward(params, cfg, toks, ctx=ctx)
    out["kv_fewer"] = logits.full_tensor().numpy()
    # expert parallelism: EP 4, and EP 2 x expert TP 2, on (1, 4)
    out["moe"] = {}
    for experts in (4, 2):
        mcfg = _moe_cfg(experts)
        ctx = make_context(mesh14, mcfg, RunConfig(remat="none"))
        params = bridge.place_params(bridge.params_from_numpy(
            payload["moe"][experts], device="cpu"), mcfg, ctx.mesh)
        toks, labs = (distribute_local(
            torch.as_tensor(payload[n]).long(), ctx.dmesh,
            ctx.placements("dp", None)) for n in ("moe_tokens", "moe_labels"))
        with torch.no_grad():
            logits, aux = T.forward(params, mcfg, toks, ctx=ctx)
        loss, grads = loss_and_grads(mcfg, params, toks, labs, ctx=ctx)
        out["moe"][experts] = {
            "logits": logits.full_tensor().numpy(),
            "aux": float(aux.full_tensor()), "ep_axis": ctx.ep_axis,
            "ep_tp_axis": ctx.ep_tp_axis,
            "view": tuple(ctx.mesh.mesh.shape),
            "loss": float(loss.full_tensor()), "grads": _full(grads)}
    # elastic restore: save from (2, 2), restore on (1, 4) and with no mesh
    out["elastic"] = {}
    for name, over in ELASTIC.items():
        ocfg = _olmo_cfg(**over)
        ckpt_dir = payload["ckpt_dir"][name]
        full = bridge.params_from_numpy(payload["olmo"][name], device="cpu")
        view22 = make_context(mesh22, ocfg, RunConfig()).mesh
        params = bridge.place_params(full, ocfg, view22)
        opt = adamw_init(params, opt_cfg)
        ckpt.save(ckpt_dir, 1, params, opt)
        view14 = make_context(mesh14, ocfg, RunConfig()).mesh
        shard14 = sharded_param_specs(abstract_params(ocfg), ocfg, view14)
        p14, o14, _ = ckpt.restore(ckpt_dir, 1, full,
                                   adamw_init(full, opt_cfg),
                                   shardings=shard14)
        plain, _, _ = ckpt.restore(ckpt_dir, 1, full)
        out["elastic"][name] = {
            "saved_data_sharded": _data_sharded(params),
            "mesh14": _full(p14),
            "placements14": {p: str(x.placements) for p, x in flatten(p14)},
            "opt_m14_is_sharded": all(type(x).__name__ == "DTensor"
                                      for x in leaves(o14.m)),
            "plain": {p: x.numpy() for p, x in flatten(plain)},
            "plain_is_plain": all(type(x) is torch.Tensor
                                  for x in leaves(plain)),
            "empty_kept": plain["layers"]["ln1"] == {}}
    return out if rank == 0 else None


def _rank_fails(rank, world, payload):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()        # rank 0 waits for a rank that never comes


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _ref_cfg(name, **over):
    from repro import configs as jcfg
    return jcfg.reduced(jcfg.get_config(name), **over)


def _np_params(cfg, seed=0):
    jax, _ = _jax()
    from repro.models import transformer as JT
    return jax.tree_util.tree_map(np.asarray,
                                  JT.init_lm(cfg, jax.random.PRNGKey(seed)))


def _np_flat(tree):
    jax, _ = _jax()
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


DENSE_KW = dict(num_layers=2, num_heads=4, num_kv_heads=2, d_model=64,
                head_dim=16, vocab_size=256, d_ff=128, dtype="float32")


def _moe_kw(experts):
    return dict(num_layers=2, num_heads=4, num_kv_heads=4, d_model=64,
                head_dim=16, vocab_size=128, moe_num_experts=experts,
                moe_top_k=2, moe_d_ff=32, moe_first_dense=1,
                moe_capacity_factor=8.0, dtype="float32")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (8, 33)).astype(np.int32)
    ftoks = np.random.default_rng(3).integers(0, 1024, (8, 33)).astype(
        np.int32)
    payload = {
        "dense": _np_params(_ref_cfg("tinyllama-1.1b", **DENSE_KW)),
        "batch": {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
        "moe": {e: _np_params(_ref_cfg("deepseek-moe-16b", **_moe_kw(e)))
                for e in (4, 2)},
        "moe_tokens": np.random.default_rng(1).integers(
            0, 128, (8, 16)).astype(np.int32),
        "moe_labels": np.random.default_rng(2).integers(
            0, 128, (8, 16)).astype(np.int32),
        "fsdp": _np_params(_ref_cfg("tinyllama-1.1b",
                                    **{**DENSE_KW, **FSDP_KW})),
        "fsdp_batch": {"tokens": ftoks[:, :-1], "labels": ftoks[:, 1:]},
        "olmo": {n: _np_params(_ref_cfg("olmo-1b", **{**OLMO_KW, **over}))
                 for n, over in ELASTIC.items()},
        "ckpt_dir": {n: str(tmp / f"ckpt-{n}") for n in ELASTIC},
    }
    return payload, spawn_group(4, _rank_all, payload, tmp, timeout=300)


@pytest.fixture(scope="module")
def reference_grads(group):
    jax, jnp = _jax()
    from repro.models import transformer as JT
    payload, _ = group
    cfg = _ref_cfg("tinyllama-1.1b", **DENSE_KW)
    b = payload["batch"]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, cfg, jnp.asarray(b["tokens"]),
                             jnp.asarray(b["labels"]))[0]))(
        jax.tree_util.tree_map(jnp.asarray, payload["dense"]))
    return float(loss), _np_flat(grads)


@pytest.mark.parametrize("remat,sp", GRAD_CASES,
                         ids=[f"remat_{r}-sp_{'on' if s else 'off'}"
                              for r, s in GRAD_CASES])
def test_sharded_grads_match_reference(group, reference_grads, remat, sp):
    _, out = group
    loss, want = reference_grads
    got = out["grads"][(remat, sp)]
    assert abs(got["loss"] - loss) <= 1e-5
    assert sorted(got["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got["grads"][k], g, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


_SINGLE = {}


def _single_device_steps(payload, mb, gc):
    """(the reference's step at lr 1e-2: loss and params; the port's step
    at lr 1e-3: grad norm and params), one device; remat and sequence
    parallelism change neither, so each (microbatches, compression) pair
    is computed once."""
    if (mb, gc) in _SINGLE:
        return _SINGLE[(mb, gc)]
    jax, jnp = _jax()
    from repro.train import compression as jcomp
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step as j_make_step
    from repro_torch import bridge
    from repro_torch.train import compression as tcomp
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import flatten
    jc = _ref_cfg("tinyllama-1.1b", **DENSE_KW)
    jo = jopt.OptimizerConfig(lr=REF_LR, warmup_steps=0)
    jp = jax.tree_util.tree_map(jnp.asarray, payload["dense"])
    jp2, _, _, jm = jax.jit(j_make_step(jc, jo, microbatches=mb,
                                        grad_compression=gc))(
        jp, jopt.adamw_init(jp, jo), jcomp.ef_init(jp) if gc else None,
        payload["batch"])
    to = topt.OptimizerConfig(lr=LR, warmup_steps=0)
    tp = bridge.params_from_numpy(payload["dense"], device="cpu")
    tp2, _, _, tm = make_train_step(_dense_cfg(), to, microbatches=mb,
                                    grad_compression=gc)(
        tp, topt.adamw_init(tp, to), tcomp.ef_init(tp) if gc else None,
        payload["batch"])
    _SINGLE[(mb, gc)] = (
        float(jm["loss"]), _np_flat(jp2), tm["grad_norm"].item(),
        {k: v.detach().numpy() for k, v in flatten(tp2)})
    return _SINGLE[(mb, gc)]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=_case_id)
def test_sharded_train_step_matches_single_device(group, case):
    payload, out = group
    mb, remat, sp, gc = case
    got = out["train"][case]
    assert got["step"] == 1
    # the grads and AdamW moments took FSDP + TP layouts (not replicated)
    assert "Shard" in got["placements"]["layers/attn/wq"]
    ref_loss, ref, port_norm, port = _single_device_steps(payload, mb, gc)
    # the reference's single-device step: loss and its criterion
    assert abs(got["loss"] - ref_loss) <= 1e-5
    flips = sum(int(np.sum(np.abs(got["params_ref_lr"][k] - v) > 5e-3))
                for k, v in ref.items())
    assert flips / sum(v.size for v in ref.values()) < 0.01
    # the port's single-device step: every param within 1e-5
    assert abs(got["grad_norm"] - port_norm) <= 1e-4
    assert sorted(port) == sorted(got["params"])
    for k, v in port.items():
        np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_kv_heads_fewer_than_tp_match_reference(group):
    """4 q / 2 KV heads on 4-way TP: the KV projections are made whole and
    each rank takes the KV head its q head reads."""
    jax, jnp = _jax()
    from repro.models import transformer as JT
    payload, out = group
    cfg = _ref_cfg("tinyllama-1.1b", **DENSE_KW)
    ref, _ = JT.forward(jax.tree_util.tree_map(jnp.asarray,
                                               payload["dense"]),
                        cfg, jnp.asarray(payload["batch"]["tokens"]))
    np.testing.assert_allclose(out["kv_fewer"], np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def _slice_aux(p, cfg, toks, ep):
    """The reference's MoE aux averaged over ``ep`` sequence slices, as a
    JAX function of the params ``p``: its own blocks up to each MoE layer's
    router input, then ``moe_apply_dense`` on each slice (the aux depends
    only on the slice's routing), summed over the MoE layers."""
    jax, jnp = _jax()
    from repro.models import moe as JM
    from repro.models import transformer as JT
    from repro.models.attention import attention_block
    from repro.models.common import norm_apply
    from repro.models.context import NULL_CTX
    s = toks.shape[1]
    positions = jnp.arange(s)[None, :]
    x = jnp.take(p["embed"], toks, axis=0)
    x = JT._dense_block(jax.tree_util.tree_map(lambda a: a[0],
                                               p["dense_layers"]),
                        x, cfg, NULL_CTX, positions)
    total = jnp.zeros((), jnp.float32)
    w = s // ep
    for li in range(cfg.num_layers - cfg.moe_first_dense):
        lp = jax.tree_util.tree_map(lambda a: a[li], p["layers"])
        h = norm_apply(cfg.norm, lp["ln1"], x)
        x = x + attention_block(lp["attn"], h, cfg, positions=positions,
                                causal=True)
        h = norm_apply(cfg.norm, lp["ln2"], x)
        total = total + sum(
            JM.moe_apply_dense(lp["moe"], h[:, r * w:(r + 1) * w], cfg)[1]
            for r in range(ep)) / ep
        y, _ = JM.moe_apply_dense(lp["moe"], h, cfg)
        x = x + y
    return total


def _reference_slice_aux(cfg, params, toks, ep):
    jax, jnp = _jax()
    return float(jax.jit(lambda p, t: _slice_aux(p, cfg, t, ep))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(toks)))


@pytest.mark.parametrize("experts", [4, 2], ids=["ep4", "ep2-tp2"])
def test_expert_parallel_forward_matches_reference(group, experts):
    jax, jnp = _jax()
    from repro.models import transformer as JT
    payload, out = group
    got = out["moe"][experts]
    ep = experts
    assert got["ep_axis"] == "a" and got["view"] == (1, ep, 4 // ep)
    assert got["ep_tp_axis"] == (None if ep == 4 else "b")
    cfg = _ref_cfg("deepseek-moe-16b", **_moe_kw(experts))
    params = payload["moe"][experts]
    toks = payload["moe_tokens"]
    ref, _ = jax.jit(lambda p, t: JT.forward(p, cfg, t))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(toks))
    np.testing.assert_allclose(got["logits"], np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    assert abs(got["aux"] - _reference_slice_aux(cfg, params, toks, ep)) \
        <= 1e-6


@pytest.mark.parametrize("experts", [4, 2], ids=["ep4", "ep2-tp2"])
def test_expert_parallel_grads_match_reference(group, experts):
    """The loss and every grad of the expert-parallel layout against the
    reference's ``jax.value_and_grad`` of the loss that layout computes:
    its nll, plus 0.01 x each MoE layer's aux averaged over the EP
    slices.  EP 2 x expert TP 2 holds the token grads summed over the
    expert-TP ranks and the router's aux grad."""
    jax, jnp = _jax()
    from repro.models import transformer as JT
    payload, out = group
    got = out["moe"][experts]
    cfg = _ref_cfg("deepseek-moe-16b", **_moe_kw(experts))
    toks = jnp.asarray(payload["moe_tokens"])
    labels = jnp.asarray(payload["moe_labels"])

    def loss_fn(p):
        nll = JT.lm_loss(p, cfg, toks, labels, aux_weight=0.0)[0]
        return nll + 0.01 * _slice_aux(p, cfg, toks, experts)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, payload["moe"][experts]))
    want = _np_flat(grads)
    assert abs(got["loss"] - float(loss)) <= 1e-5
    assert sorted(got["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got["grads"][k], g, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


_FSDP_SINGLE = {}


@pytest.mark.parametrize("mb", FSDP_MICROBATCHES, ids=lambda m: f"mb{m}")
def test_fsdp_train_step_matches_single_device(group, mb):
    """One step on (2, 2) of a config whose larger leaves shard over "data"
    as well as over TP: the loss against the reference's, the grad norm and
    every param after the AdamW step against the port's single-device
    step."""
    jax, jnp = _jax()
    from repro.models import transformer as JT
    from repro_torch import bridge
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.train.tree import flatten
    payload, out = group
    got = out["fsdp"][mb]
    assert set(FSDP_LEAVES) <= set(got["data_sharded"])
    assert set(FSDP_LEAVES) <= set(got["moments_sharded"])
    b = payload["fsdp_batch"]
    ref_loss, _ = JT.lm_loss(
        jax.tree_util.tree_map(jnp.asarray, payload["fsdp"]),
        _ref_cfg("tinyllama-1.1b", **{**DENSE_KW, **FSDP_KW}),
        jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    assert abs(got["loss"] - float(ref_loss)) <= 1e-5
    if mb not in _FSDP_SINGLE:
        to = topt.OptimizerConfig(lr=LR, warmup_steps=0)
        tp = bridge.params_from_numpy(payload["fsdp"], device="cpu")
        _, tg = loss_and_grads(_fsdp_cfg(), tp,
                               *(torch.as_tensor(b[n]).long()
                                 for n in ("tokens", "labels")))
        tp2, _, _, tm = make_train_step(_fsdp_cfg(), to, microbatches=mb)(
            tp, topt.adamw_init(tp, to), None, b)
        _FSDP_SINGLE[mb] = (tm["grad_norm"].item(),
                            {k: v.detach().numpy() for k, v in flatten(tp2)},
                            {k: v.numpy() for k, v in flatten(tg)})
    port_norm, port, grads = _FSDP_SINGLE[mb]
    assert abs(got["grad_norm"] - port_norm) <= 1e-4
    assert sorted(port) == sorted(got["params"])
    # every element at 1e-5 but those whose clipped grad is near AdamW's
    # eps (1e-8), where the first step's g / (|g| + eps) turns a
    # summation-order difference into a move of up to lr: those, at most 1%
    # of the params, at 2 · lr (tests/test_torch_train.py::_close_step)
    clip = min(1.0, 1.0 / (port_norm + 1e-9))
    blunt = 0
    for k, v in port.items():
        sharp = (np.abs(grads[k]) * clip >= 100 * 1e-8) | (grads[k] == 0)
        blunt += int((~sharp).sum())
        np.testing.assert_allclose(got["params"][k][sharp], v[sharp],
                                   atol=1e-5, rtol=1e-5, err_msg=k)
        assert (np.abs(got["params"][k] - v)[~sharp] <= 2 * LR + 1e-5).all()
    assert blunt <= 0.01 * sum(v.size for v in port.values())


@pytest.mark.parametrize("name", list(ELASTIC))
def test_elastic_restore(group, name):
    """Saved from (2, 2); restored on (1, 4) and with no mesh, every leaf
    exact; the reference's ``checkpoint.restore`` reads the same files
    exactly.  In the "fsdp" case the larger leaves were saved from shards
    over "data" as well as over TP."""
    jax, jnp = _jax()
    from repro.train import checkpoint as jckpt
    from repro.train import optimizer as jopt
    payload, out = group
    want = _np_flat(payload["olmo"][name])
    el = out["elastic"][name]
    assert ("embed" in el["saved_data_sharded"]) == (name == "fsdp")
    assert el["empty_kept"] and el["plain_is_plain"]
    assert el["opt_m14_is_sharded"]
    assert "Shard" in el["placements14"]["layers/attn/wq"]
    assert sorted(el["mesh14"]) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(el["mesh14"][k], v), k
        assert np.array_equal(el["plain"][k], v), k
    jp = jax.tree_util.tree_map(jnp.asarray, payload["olmo"][name])
    template = jopt.adamw_init(jp, jopt.OptimizerConfig(lr=LR,
                                                        warmup_steps=0))
    rp, ro, meta = jckpt.restore(payload["ckpt_dir"][name], 1, jp, template)
    assert meta["step"] == 1
    for k, v in _np_flat(rp).items():
        assert np.array_equal(v, want[k]), k
    for x in jax.tree_util.tree_leaves((ro.m, ro.v)):
        assert not np.any(np.asarray(x))


def test_failing_rank_fails_its_group(tmp_path):
    from repro_torch.testing import RankGroupError
    t0 = time.monotonic()
    with pytest.raises(RankGroupError,
                       match="(?s)rank 1 of 2 failed.*rank 1 fails on "
                             "purpose"):
        spawn_group(2, _rank_fails, {}, tmp_path, timeout=60)
    assert time.monotonic() - t0 < 60
