"""Port vs reference under a mesh: the ssm (RWKV6) and hybrid (zamba2)
families, the twins of ``tests/test_distributed.py`` for the recurrence
kernel's mesh path.

One group of 4 spawned ranks on the CPU (``repro_torch.testing.run_ranks``:
gloo, a ``FileStore`` under the test's ``tmp_path``, the group's own
deadline) computes every case (module fixture ``group``); each test then
holds one case against the reference, which runs in this process on the
same params (bridged) and batches.  The ranks import only torch and the
port.

Configs: reduced rwkv6-3b (4 heads of 16) and reduced zamba2-2.7b with
``num_layers=4`` (two groups, so ``x0`` is carried and the shared block
runs twice), both float32.  Cases: (data 2, model 2) and (data 1, model 4),
sequence parallelism on and off, remat none and full; the uneven case of
rwkv6 with ``rwkv_head_dim=32`` (2 heads) on (1, 4), where the heads split
over "a" (2) and stay whole over "b" (2); one AdamW step (lr 1e-3) on
(2, 2) against the port's single-device step; and the kernel boundary
``kernels.ops._sharded_rwkv6_mix`` alone with q replicated and v split
over the heads; an elastic restore of each tree saved from (2, 2) onto
(1, 4) and with no mesh.  Tolerances: loss 1e-5 and every grad 1e-4 against the
reference's ``jax.value_and_grad(lm_loss)``; params after the step 1e-5
(AdamW's near-eps elements at 2 · lr, as the FSDP step test holds them);
the boundary's output, final state and grads 1e-6 against the call with no
mesh; checkpoints exact.

The grad cases use the token seed (1) of ``tests/test_torch_hybrid.py``'s
grad test.  Token seed 0 is held on two meshes as the rounding cases: in
float64 (``repro_torch.testing.precision``) the sharded loss and grads
equal the single device's to 1e-10, so the sharded path computes the same
function; in float32 zamba2's sharded grads there sit past 1e-4 from the
reference's, because random Mamba2 blocks amplify rounding, so they are
held to their distance from the float64 grads, at most 3 times the single
device's or the reference's own (``scripts/ssm_rounding.py`` measures it
over six token seeds).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCHS = {"rwkv6-3b": dict(dtype="float32"),
         "zamba2-2.7b": dict(dtype="float32", num_layers=4)}
UNEVEN = ("rwkv6-3b", dict(dtype="float32", rwkv_head_dim=32))
# (mesh, sequence_parallel, remat): each mesh with sequence parallelism on
# and off, each remat policy on each mesh
GRAD_CASES = [((2, 2), False, "none"), ((2, 2), True, "full"),
              ((1, 4), True, "none"), ((1, 4), False, "full")]
BATCH, SEQ, TOKEN_SEED = 4, 32, 1
LR = 1e-3
# token seed 0 on two of the meshes, in float32 and in float64
# (``repro_torch.testing.precision``): the rounding cases
ROUNDING_SEED = 0
ROUNDING_CASES = [GRAD_CASES[1], GRAD_CASES[3]]


def _case_id(case):
    mesh, sp, remat = case
    return f"{mesh[0]}x{mesh[1]}-sp_{'on' if sp else 'off'}-remat_{remat}"


# ---------------------------------------------------------------------------
# the ranks' side (torch and the port only)
# ---------------------------------------------------------------------------

def _port_cfg(arch, over):
    from repro_torch import configs
    return configs.reduced(configs.get_config(arch), **over)


def _full(tree):
    """{path: numpy} of a tree of DTensors (a collective on every rank)."""
    from repro_torch.train.tree import flatten
    return {p: x.full_tensor().detach().numpy() for p, x in flatten(tree)}


def _grads_case(cfg, params_np, batch, mesh, sp, remat,
                dtype=torch.float32):
    from repro_torch import bridge
    from repro_torch.configs import RunConfig
    from repro_torch.parallel.sharding import distribute_local, make_context
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.tree import tree_map
    ctx = make_context(mesh, cfg, RunConfig(remat=remat,
                                            sequence_parallel=sp))
    params = bridge.place_params(tree_map(
        lambda x: x.to(dtype), bridge.params_from_numpy(params_np,
                                                        device="cpu")),
        cfg, ctx.mesh)
    rows = ctx.placements("dp", None)
    tok, lab = (distribute_local(torch.as_tensor(batch[n]).long(),
                                 ctx.dmesh, rows)
                for n in ("tokens", "labels"))
    loss, grads = loss_and_grads(cfg, params, tok, lab, ctx=ctx)
    return {"loss": float(loss.full_tensor()), "grads": _full(grads),
            "view": tuple(ctx.mesh.mesh.shape)}


def _step_case(cfg, params_np, batch, mesh):
    from repro_torch import bridge
    from repro_torch.configs import RunConfig
    from repro_torch.parallel.sharding import make_context
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import flatten
    ctx = make_context(mesh, cfg, RunConfig(remat="none"))
    params = bridge.place_params(bridge.params_from_numpy(
        params_np, device="cpu"), cfg, ctx.mesh)
    opt = OptimizerConfig(lr=LR, warmup_steps=0)
    p2, st2, _, m = make_train_step(cfg, opt, ctx=ctx)(
        params, adamw_init(params, opt), None, batch)
    return {"params": _full(p2), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "step": int(st2.step),
            "placements": {p: str(x.placements) for p, x in flatten(p2)}}


def _boundary_case(mesh, inputs):
    """``_sharded_rwkv6_mix`` with q replicated (Mamba2's C broadcast over
    the heads), v split over the heads on "model" and its batch rows on
    "data", k and the log decay replicated: the shapes each rank's
    Function call sees, and the output, final state and grads in full."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import distribute_local
    seen = []
    real = ops._Rwkv6Mix

    class Recording(real):
        @staticmethod
        def apply(*args):
            seen.append(tuple(args[0].shape))
            return real.apply(*args)

    names = ("q", "k", "v", "log_decay")
    lay = {"q": [Shard(0), Replicate()], "k": [Shard(0), Replicate()],
           "v": [Shard(0), Shard(1)], "log_decay": [Shard(0), Replicate()]}
    ts = {n: distribute_local(torch.as_tensor(inputs[n]), mesh, lay[n])
          .requires_grad_() for n in names}
    ops._Rwkv6Mix = Recording
    out, S = ops.rwkv6_mix_state(*(ts[n] for n in names), chunk=8)
    ops._Rwkv6Mix = real
    g_out, g_s = (distribute_local(torch.as_tensor(inputs[n]), mesh,
                                   out_lay.placements)
                  for n, out_lay in (("g_out", out), ("g_s", S)))
    grads = torch.autograd.grad((out, S), [ts[n] for n in names],
                                (g_out, g_s))
    return {"seen": seen, "out": out.full_tensor().detach().numpy(),
            "S": S.full_tensor().detach().numpy(),
            "out_placements": str(out.placements),
            "grads": {n: g.full_tensor().numpy()
                      for n, g in zip(names, grads)}}


def _elastic_case(cfg, params_np, ckpt_dir, meshes):
    """Saved from (2, 2), restored on (1, 4) and with no mesh."""
    from repro_torch import bridge
    from repro_torch.configs import RunConfig
    from repro_torch.launch.dryrun import sharded_param_specs
    from repro_torch.parallel.sharding import abstract_params, make_context
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.tree import flatten
    opt_cfg = OptimizerConfig(lr=LR, warmup_steps=0)
    full = bridge.params_from_numpy(params_np, device="cpu")
    view22 = make_context(meshes[(2, 2)], cfg, RunConfig()).mesh
    params = bridge.place_params(full, cfg, view22)
    ckpt.save(ckpt_dir, 1, params, adamw_init(params, opt_cfg))
    view14 = make_context(meshes[(1, 4)], cfg, RunConfig()).mesh
    p14, _, _ = ckpt.restore(ckpt_dir, 1, full, adamw_init(full, opt_cfg),
                             shardings=sharded_param_specs(
                                 abstract_params(cfg), cfg, view14))
    plain, _, _ = ckpt.restore(ckpt_dir, 1, full)
    return {"mesh14": _full(p14),
            "sharded14": [p for p, x in flatten(p14)
                          if "Shard" in str(x.placements)],
            "plain": {p: x.numpy() for p, x in flatten(plain)}}


def _rank_all(rank, world, payload):
    import logging

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.testing import gloo_cuda
    gloo_cuda.use_c10d_collectives()
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    meshes = {shape: make_smoke_mesh(shape, device="cpu")
              for shape in ((2, 2), (1, 4))}
    from repro_torch.testing.precision import float64_compute
    out = {"grads": {}, "step": {}, "rounding": {}}
    for arch, over in ARCHS.items():
        cfg = _port_cfg(arch, over)
        for case in GRAD_CASES:
            mesh, sp, remat = case
            out["grads"][(arch, case)] = _grads_case(
                cfg, payload["params"][arch], payload["batch"][arch],
                meshes[mesh], sp, remat)
        for case in ROUNDING_CASES:
            mesh, sp, remat = case
            args = (cfg, payload["params"][arch],
                    payload["rounding_batch"][arch], meshes[mesh], sp, remat)
            with float64_compute():
                wide = _grads_case(*args, dtype=torch.float64)
            out["rounding"][(arch, case)] = {"float32": _grads_case(*args),
                                             "float64": wide}
        out["step"][arch] = _step_case(cfg, payload["params"][arch],
                                       payload["batch"][arch],
                                       meshes[(2, 2)])
    arch, over = UNEVEN
    out["uneven"] = _grads_case(_port_cfg(arch, over),
                                payload["params"]["uneven"],
                                payload["batch"][arch], meshes[(1, 4)],
                                False, "none")
    out["boundary"] = _boundary_case(meshes[(2, 2)], payload["boundary"])
    out["elastic"] = {arch: _elastic_case(
        _port_cfg(arch, over), payload["params"][arch],
        payload["ckpt_dir"][arch], meshes) for arch, over in ARCHS.items()}
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _ref_cfg(arch, over):
    from repro import configs as jcfg
    return jcfg.reduced(jcfg.get_config(arch), **over)


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


def _batch(cfg, seed=TOKEN_SEED):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _boundary_inputs():
    """Mamba2's operands at (B 2, H 4, T 16, K 8, V 4): q is C broadcast
    over the heads, the log decay one value per (b, h, t) over K."""
    rng = np.random.default_rng(5)
    b, h, t, k, v = 2, 4, 16, 8, 4
    c = rng.normal(size=(b, 1, t, k)).astype(np.float32)
    ld = -np.exp(rng.normal(size=(b, h, t, 1)) - 1.0).astype(np.float32)
    return {"q": np.ascontiguousarray(np.broadcast_to(c, (b, h, t, k))),
            "k": rng.normal(size=(b, h, t, k)).astype(np.float32),
            "v": rng.normal(size=(b, h, t, v)).astype(np.float32),
            "log_decay": np.ascontiguousarray(
                np.broadcast_to(ld, (b, h, t, k))),
            "g_out": rng.normal(size=(b, h, t, v)).astype(np.float32),
            "g_s": rng.normal(size=(b, h, k, v)).astype(np.float32)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from repro_torch.testing import run_ranks
    tmp = tmp_path_factory.mktemp("dist-ssm")
    ref_cfgs = {arch: _ref_cfg(arch, over) for arch, over in ARCHS.items()}
    payload = {
        "params": {**{arch: _np_params(c) for arch, c in ref_cfgs.items()},
                   "uneven": _np_params(_ref_cfg(*UNEVEN))},
        "batch": {arch: _batch(c) for arch, c in ref_cfgs.items()},
        "rounding_batch": {arch: _batch(c, ROUNDING_SEED)
                           for arch, c in ref_cfgs.items()},
        "boundary": _boundary_inputs(),
        "ckpt_dir": {arch: str(tmp / f"ckpt-{arch}") for arch in ARCHS},
    }
    out = run_ranks(_rank_all, 4, (payload,), workdir=tmp, timeout=600)[0]
    return payload, out


_REFERENCE = {}


def _reference(payload, arch, over, params_key, batch_key="batch"):
    """The reference's loss and grads of ``lm_loss`` on one device."""
    key = (arch, params_key, batch_key)
    if key not in _REFERENCE:
        jax, jnp = _jax()
        from repro.models import transformer as JT
        cfg = _ref_cfg(arch, over)
        b = payload[batch_key][arch]
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JT.lm_loss(p, cfg, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["labels"]))[0]))(
            jax.tree_util.tree_map(jnp.asarray, payload["params"][params_key]))
        _REFERENCE[key] = (float(loss), _np_flat(grads))
    return _REFERENCE[key]


def _hold(got, loss, want):
    assert abs(got["loss"] - loss) <= 1e-5
    assert sorted(got["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got["grads"][k], g, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("case", GRAD_CASES, ids=_case_id)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_grads_match_reference(group, arch, case):
    payload, out = group
    got = out["grads"][(arch, case)]
    mesh = case[0]
    assert got["view"][0] == mesh[0]
    assert got["view"][1] * got["view"][2] == mesh[1]
    _hold(got, *_reference(payload, arch, ARCHS[arch], arch))


def test_uneven_heads_match_reference(group):
    """rwkv6 with 2 heads of 32 on (1, 4): the view is (1, 2, 2) and the
    heads split over "a" alone; no rank holds part of a head."""
    payload, out = group
    got = out["uneven"]
    assert got["view"] == (1, 2, 2)
    _hold(got, *_reference(payload, *UNEVEN, "uneven"))


_WIDE = {}


def _single_device(payload, arch, dtype):
    """The port's single-device loss and grads on the rounding batch, in
    float32 or (under ``float64_compute``) in float64."""
    key = (arch, dtype)
    if key not in _WIDE:
        from repro_torch import bridge
        from repro_torch.testing.precision import float64_compute
        from repro_torch.train.train_step import loss_and_grads
        from repro_torch.train.tree import flatten, tree_map
        b = payload["rounding_batch"][arch]
        params = tree_map(lambda x: x.to(dtype), bridge.params_from_numpy(
            payload["params"][arch], device="cpu"))
        tok, lab = (torch.as_tensor(b[n]).long() for n in ("tokens",
                                                           "labels"))
        cfg = _port_cfg(arch, ARCHS[arch])
        if dtype == torch.float64:
            with float64_compute():
                loss, grads = loss_and_grads(cfg, params, tok, lab)
        else:
            loss, grads = loss_and_grads(cfg, params, tok, lab)
        _WIDE[key] = (float(loss), {k: v.numpy() for k, v in flatten(grads)})
    return _WIDE[key]


def _rel(got, want):
    """|got - want| / |want| over every grad together."""
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


@pytest.mark.parametrize("case", ROUNDING_CASES, ids=_case_id)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_float64_equals_single_device(group, arch, case):
    """On the rounding batch (token seed 0), in float64: the sharded loss
    and every grad equal the single device's to float64's rounding (1e-10),
    so the sharded path computes the single device's function, and a
    float32 gap between the two is rounding (the next test)."""
    payload, out = group
    got = out["rounding"][(arch, case)]["float64"]
    loss, want = _single_device(payload, arch, torch.float64)
    assert abs(got["loss"] - loss) <= 1e-10
    assert sorted(got["grads"]) == sorted(want)
    for k, w in want.items():
        assert got["grads"][k].dtype == np.float64, k
        np.testing.assert_allclose(got["grads"][k], w, atol=1e-10,
                                   rtol=1e-10, err_msg=k)


@pytest.mark.parametrize("case", ROUNDING_CASES, ids=_case_id)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_float32_gap_is_rounding(group, arch, case):
    """On the rounding batch (token seed 0), in float32: the loss within
    1e-5 of the reference's, and |g - g64| / |g64| over all grads at most
    3 times the larger of the single device's and the reference's own.
    On this batch zamba2's sharded embed grad sits 2.1e-4 from the
    reference's, past the 1e-4 of the other cases, with the float64 runs
    equal (the test above): random Mamba2 blocks amplify float32 rounding,
    and the sharded path rounds at more places (partial sums, their
    all-reduces).  Over token seeds 0-5 its distance from float64 ran
    0.4-5.1 times the single device's (``scripts/ssm_rounding.py``, on the
    port's own draw of the params; ``PERF.md``); here, 1.2-1.8 times."""
    payload, out = group
    got = out["rounding"][(arch, case)]["float32"]
    ref_loss, ref = _reference(payload, arch, ARCHS[arch], arch,
                               "rounding_batch")
    assert abs(got["loss"] - ref_loss) <= 1e-5
    _, wide = _single_device(payload, arch, torch.float64)
    _, single = _single_device(payload, arch, torch.float32)
    floor = max(_rel(single, wide), _rel(ref, wide))
    assert floor < 1e-4
    assert _rel(got["grads"], wide) <= 3 * floor


_SINGLE = {}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_train_step_matches_single_device(group, arch):
    """One AdamW step (lr 1e-3) on (2, 2): the loss against the
    reference's, the grad norm and every param against the port's
    single-device step, as ``tests/test_torch_distributed.py::
    test_fsdp_train_step_matches_single_device`` holds them: 1e-5 on every
    element but those whose clipped grad is near AdamW's eps (1e-8), where
    the first step's g / (|g| + eps) turns a summation-order difference
    into a move of up to lr (RWKV6's squared-ReLU channel mix leaves such
    grads): those, at most 1% of the params, at 2 · lr."""
    from repro_torch import bridge
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.train.tree import flatten
    payload, out = group
    got = out["step"][arch]
    assert got["step"] == 1
    # the params and their AdamW moments keep the TP layouts
    first = "layers/tmix/w_r" if arch == "rwkv6-3b" else "layers/mamba/w_in"
    assert "Shard" in got["placements"][first]
    loss, _ = _reference(payload, arch, ARCHS[arch], arch)
    assert abs(got["loss"] - loss) <= 1e-5
    if arch not in _SINGLE:
        cfg = _port_cfg(arch, ARCHS[arch])
        b = payload["batch"][arch]
        opt = topt.OptimizerConfig(lr=LR, warmup_steps=0)
        tp = bridge.params_from_numpy(payload["params"][arch], device="cpu")
        _, tg = loss_and_grads(cfg, tp, *(torch.as_tensor(b[n]).long()
                                          for n in ("tokens", "labels")))
        p2, _, _, m = make_train_step(cfg, opt)(
            tp, topt.adamw_init(tp, opt), None, b)
        _SINGLE[arch] = (m["grad_norm"].item(),
                         {k: v.detach().numpy() for k, v in flatten(p2)},
                         {k: v.numpy() for k, v in flatten(tg)})
    norm, want, grads = _SINGLE[arch]
    assert abs(got["grad_norm"] - norm) <= 1e-4
    assert sorted(got["params"]) == sorted(want)
    clip = min(1.0, 1.0 / (norm + 1e-9))
    blunt = 0
    for k, v in want.items():
        sharp = (np.abs(grads[k]) * clip >= 100 * 1e-8) | (grads[k] == 0)
        blunt += int((~sharp).sum())
        np.testing.assert_allclose(got["params"][k][sharp], v[sharp],
                                   atol=1e-5, rtol=1e-5, err_msg=k)
        assert (np.abs(got["params"][k] - v)[~sharp] <= 2 * LR + 1e-5).all()
    assert blunt <= 0.01 * sum(v.size for v in want.values())


def test_sharded_recurrence_runs_local_heads(group):
    """``_sharded_rwkv6_mix`` with q whole over the heads and v split over
    them on "model" (2 ways): each rank's Function call sees its 2 of 4 heads
    and its batch row, the output takes v's split, and the output, final
    state and every grad equal the call with no mesh."""
    from repro_torch.kernels import ops
    payload, out = group
    got = out["boundary"]
    ins = {n: torch.as_tensor(payload["boundary"][n]).requires_grad_()
           for n in ("q", "k", "v", "log_decay")}
    assert got["seen"] == [(1, 2, 16, 8)]
    assert "Shard(dim=1)" in got["out_placements"]
    o, S = ops.rwkv6_mix_state(*ins.values(), chunk=8)
    grads = torch.autograd.grad(
        (o, S), list(ins.values()),
        tuple(torch.as_tensor(payload["boundary"][n])
              for n in ("g_out", "g_s")))
    np.testing.assert_allclose(got["out"], o.detach().numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got["S"], S.detach().numpy(), atol=1e-6,
                               rtol=1e-6)
    for n, g in zip(ins, grads):
        np.testing.assert_allclose(got["grads"][n], g.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=n)


# leaves of each family that only its tree has, which a restore on (1, 4)
# must lay out split
SPLIT_ON_RESTORE = {"rwkv6-3b": ("layers/tmix/w_r", "layers/cmix/w_v"),
                    "zamba2-2.7b": ("layers/mamba/w_in", "layers/mamba/conv",
                                    "shared_proj", "shared_block/attn/wq")}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_elastic_restore(group, arch):
    """The ssm and hybrid trees (bonus, token-shift mixes, decay base; the
    conv, A, dt bias, the unstacked shared block and its projection) saved
    from (2, 2) and restored on (1, 4) and with no mesh, every leaf exact;
    the reference's ``checkpoint.restore`` reads the same files
    exactly."""
    jax, jnp = _jax()
    from repro.train import checkpoint as jckpt
    payload, out = group
    want = _np_flat(payload["params"][arch])
    el = out["elastic"][arch]
    assert set(SPLIT_ON_RESTORE[arch]) <= set(el["sharded14"])
    assert sorted(el["mesh14"]) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(el["mesh14"][k], v), k
        assert np.array_equal(el["plain"][k], v), k
    jp = jax.tree_util.tree_map(jnp.asarray, payload["params"][arch])
    rp, _, meta = jckpt.restore(payload["ckpt_dir"][arch], 1, jp)
    assert meta["step"] == 1
    for k, v in _np_flat(rp).items():
        assert np.array_equal(v, want[k]), k
