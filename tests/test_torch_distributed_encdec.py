"""Port vs reference under a mesh: the audio (whisper-base, an
encoder-decoder on frame embeddings) and vlm (phi-3-vision-4.2b, patch
embeddings) families, the twins of ``tests/test_distributed.py`` for the
encoder, the cross attention and the patch path.

One group of 4 spawned ranks on the CPU (``repro_torch.testing.run_ranks``:
gloo, a ``FileStore`` under the test's ``tmp_path``, the group's own
deadline) computes every case (module fixture ``group``); each test then
holds one case against the reference, which runs in this process on the
same params (bridged) and batches.  The ranks import only torch and the
port.

Configs, reduced and float32: whisper-base on 24 frames against 16 tokens
(S_enc != S: the encoder's non-causal blocks, each decoder layer's cross
attention at Sq 16, Skv 24 on each rank's local heads), also with an odd
vocab of 255, which no TP split divides (whisper's own 51865 does not
either: the embedding and the loss keep the vocab whole), and with
attention biases (``qkv_bias``; whisper-base's config has none), split over
tp as ``attn/b[qkv]`` are in the encoder, decoder and cross attention;
phi-3-vision-4.2b with 8 patch embeddings in place
of the first 8 tokens (``patch_proj``'s columns split over tp).  Cases:
(data 2, model 2) and (data 1, model 4), sequence parallelism on and off,
remat none and full; one AdamW step (lr 1e-3) on (2, 2) against the port's
single-device step; an elastic restore of each tree saved from (2, 2) onto
(1, 4) and with no mesh.  Tolerances: loss 1e-5 and every grad 1e-4
against the reference's ``jax.value_and_grad(lm_loss)``; params after the
step 1e-5 (AdamW's near-eps elements at 2 · lr, as
``tests/test_torch_distributed_ssm.py`` holds them); checkpoints exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCHS = {"whisper-base": dict(dtype="float32"),
         "phi-3-vision-4.2b": dict(dtype="float32"),
         "whisper-odd-vocab": dict(dtype="float32", vocab_size=255,
                                   qkv_bias=True)}
# (mesh, sequence_parallel, remat), as the ssm file's
GRAD_CASES = [((2, 2), False, "none"), ((2, 2), True, "full"),
              ((1, 4), True, "none"), ((1, 4), False, "full")]
BATCH, SEQ, FRAMES, PATCHES, TOKEN_SEED = 4, 16, 24, 8, 1
LR = 1e-3
STEP_ARCHS = ("whisper-base", "phi-3-vision-4.2b")


def _arch(name):
    return "whisper-base" if name == "whisper-odd-vocab" else name


def _case_id(case):
    mesh, sp, remat = case
    return f"{mesh[0]}x{mesh[1]}-sp_{'on' if sp else 'off'}-remat_{remat}"


# ---------------------------------------------------------------------------
# the ranks' side (torch and the port only)
# ---------------------------------------------------------------------------

def _port_cfg(name):
    from repro_torch import configs
    return configs.reduced(configs.get_config(_arch(name)), **ARCHS[name])


def _full(tree):
    """{path: numpy} of a tree of DTensors (a collective on every rank)."""
    from repro_torch.train.tree import flatten
    return {p: x.full_tensor().detach().numpy() for p, x in flatten(tree)}


def _grads_case(cfg, params_np, batch, mesh, sp, remat):
    from repro_torch import bridge
    from repro_torch.configs import RunConfig
    from repro_torch.kernels import ops
    from repro_torch.parallel.sharding import distribute_local, make_context
    from repro_torch.train.train_step import loss_and_grads
    ctx = make_context(mesh, cfg, RunConfig(remat=remat,
                                            sequence_parallel=sp))
    params = bridge.place_params(bridge.params_from_numpy(
        params_np, device="cpu"), cfg, ctx.mesh)

    def rows(x):
        x = torch.as_tensor(x)
        return distribute_local(x.long() if x.dtype == torch.int32 else x,
                                ctx.dmesh, ctx.placements(
                                    "dp", *[None] * (x.dim() - 1)))
    extras = {n: rows(batch[n]) for n in ("frame_embeds", "patch_embeds")
              if n in batch}
    shapes = []
    real = ops.flash_attention_plain

    def recording(q, k, v, causal, window):
        shapes.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal, window)
    ops.flash_attention_plain = recording
    loss, grads = loss_and_grads(cfg, params, rows(batch["tokens"]),
                                 rows(batch["labels"]), ctx=ctx, **extras)
    ops.flash_attention_plain = real
    return {"loss": float(loss.full_tensor()), "grads": _full(grads),
            "view": tuple(ctx.mesh.mesh.shape), "shapes": shapes}


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
    out = {"grads": {}, "step": {}, "elastic": {}}
    for name in ARCHS:
        cfg = _port_cfg(name)
        for case in GRAD_CASES:
            mesh, sp, remat = case
            out["grads"][(name, case)] = _grads_case(
                cfg, payload["params"][name], payload["batch"][name],
                meshes[mesh], sp, remat)
    for name in STEP_ARCHS:
        cfg = _port_cfg(name)
        out["step"][name] = _step_case(cfg, payload["params"][name],
                                       payload["batch"][name],
                                       meshes[(2, 2)])
        out["elastic"][name] = _elastic_case(
            cfg, payload["params"][name], payload["ckpt_dir"][name], meshes)
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
    return jcfg.reduced(jcfg.get_config(_arch(name)), **ARCHS[name])


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
    if cfg.frontend == "patch":
        out["patch_embeds"] = rng.normal(
            size=(BATCH, PATCHES, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    jax, _ = _jax()
    from repro.models import transformer as JT
    from repro_torch.testing import run_ranks
    tmp = tmp_path_factory.mktemp("dist-encdec")
    ref_cfgs = {name: _ref_cfg(name) for name in ARCHS}
    payload = {
        "params": {name: jax.tree_util.tree_map(
            np.asarray, JT.init_lm(c, jax.random.PRNGKey(0)))
            for name, c in ref_cfgs.items()},
        "batch": {name: _batch(c) for name, c in ref_cfgs.items()},
        "ckpt_dir": {name: str(tmp / f"ckpt-{name}") for name in STEP_ARCHS},
    }
    out = run_ranks(_rank_all, 4, (payload,), workdir=tmp, timeout=600)[0]
    return payload, out


_REFERENCE = {}


def _reference(payload, name):
    """The reference's loss and grads of ``lm_loss`` on one device."""
    if name not in _REFERENCE:
        jax, jnp = _jax()
        from repro.models import transformer as JT
        cfg = _ref_cfg(name)
        b = payload["batch"][name]
        extras = {n: jnp.asarray(b[n]) for n in ("frame_embeds",
                                                 "patch_embeds") if n in b}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JT.lm_loss(p, cfg, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["labels"]), **extras)[0]))(
            jax.tree_util.tree_map(jnp.asarray, payload["params"][name]))
        _REFERENCE[name] = (float(loss), _np_flat(grads))
    return _REFERENCE[name]


@pytest.mark.parametrize("case", GRAD_CASES, ids=_case_id)
@pytest.mark.parametrize("name", list(ARCHS))
def test_sharded_grads_match_reference(group, name, case):
    """Loss 1e-5 and every grad 1e-4 against ``jax.value_and_grad``; the
    attention's plain version (the kernel's, on the CPU) runs on each
    rank's batch rows and local heads: whisper's encoder (24 x 24,
    non-causal), self (16 x 16, causal) and cross (16 x 24, non-causal)
    attention, phi-3's causal self attention."""
    payload, out = group
    got = out["grads"][(name, case)]
    mesh = case[0]
    assert got["view"][0] == mesh[0]
    assert got["view"][1] * got["view"][2] == mesh[1]
    loss, want = _reference(payload, name)
    assert abs(got["loss"] - loss) <= 1e-5
    assert sorted(got["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got["grads"][k], g, atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    cfg = _port_cfg(name)
    rows = BATCH // mesh[0]
    heads = cfg.num_heads // mesh[1]
    kinds = {(q[1], k[1], causal) for q, k, causal in got["shapes"]}
    want_kinds = {(SEQ, SEQ, True)}
    if cfg.is_encoder_decoder:
        want_kinds |= {(FRAMES, FRAMES, False), (SEQ, FRAMES, False)}
    assert kinds == want_kinds
    assert {(q[0], q[2]) for q, _, _ in got["shapes"]} == {(rows, heads)}


_SINGLE = {}


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_sharded_train_step_matches_single_device(group, name):
    """One AdamW step (lr 1e-3) on (2, 2): the loss against the
    reference's, the grad norm and every param against the port's
    single-device step, 1e-5 except elements whose clipped grad is near
    AdamW's eps, at 2 · lr (at most 1% of the params), as
    ``tests/test_torch_distributed_ssm.py`` holds them."""
    from repro_torch import bridge
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import loss_and_grads, make_train_step
    from repro_torch.train.tree import flatten
    payload, out = group
    got = out["step"][name]
    assert got["step"] == 1
    first = ("cross_attn/attn/wq" if name == "whisper-base"
             else "patch_proj")
    assert "Shard" in got["placements"][first]
    loss, _ = _reference(payload, name)
    assert abs(got["loss"] - loss) <= 1e-5
    if name not in _SINGLE:
        cfg = _port_cfg(name)
        b = payload["batch"][name]
        opt = topt.OptimizerConfig(lr=LR, warmup_steps=0)
        tp = bridge.params_from_numpy(payload["params"][name], device="cpu")
        extras = {n: torch.as_tensor(b[n]) for n in ("frame_embeds",
                                                     "patch_embeds")
                  if n in b}
        _, tg = loss_and_grads(cfg, tp, *(torch.as_tensor(b[n]).long()
                                          for n in ("tokens", "labels")),
                               **extras)
        p2, _, _, m = make_train_step(cfg, opt)(
            tp, topt.adamw_init(tp, opt), None, b)
        _SINGLE[name] = (m["grad_norm"].item(),
                         {k: v.detach().numpy() for k, v in flatten(p2)},
                         {k: v.numpy() for k, v in flatten(tg)})
    norm, want, grads = _SINGLE[name]
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


# leaves of each family that only its tree has, which a restore on (1, 4)
# must lay out split
SPLIT_ON_RESTORE = {"whisper-base": ("encoder_layers/attn/wq",
                                     "cross_attn/attn/wk"),
                    "phi-3-vision-4.2b": ("patch_proj", "layers/attn/wq")}


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_elastic_restore(group, name):
    """The enc-dec and vlm trees (encoder layers, cross attention,
    ``ln_enc``; ``patch_proj``) saved from (2, 2) and restored on (1, 4)
    and with no mesh, every leaf exact; the reference's
    ``checkpoint.restore`` reads the same files exactly."""
    jax, jnp = _jax()
    from repro.train import checkpoint as jckpt
    payload, out = group
    want = _np_flat(payload["params"][name])
    el = out["elastic"][name]
    assert set(SPLIT_ON_RESTORE[name]) <= set(el["sharded14"])
    assert sorted(el["mesh14"]) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(el["mesh14"][k], v), k
        assert np.array_equal(el["plain"][k], v), k
    jp = jax.tree_util.tree_map(jnp.asarray, payload["params"][name])
    rp, _, meta = jckpt.restore(payload["ckpt_dir"][name], 1, jp)
    assert meta["step"] == 1
    for k, v in _np_flat(rp).items():
        assert np.array_equal(v, want[k]), k
