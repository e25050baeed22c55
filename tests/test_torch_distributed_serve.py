"""Port vs reference under a mesh: serving, a one-pass prefill into a
sharded decode state and decode steps, for every family (the twins of the
reference's ``prefill`` / ``decode_step`` sharded by GSPMD).

One group of 4 spawned ranks on the CPU (``repro_torch.testing.run_ranks``:
gloo, a ``FileStore`` under the test's ``tmp_path``, the group's own
deadline) serves every case (module fixture ``group``); each test then
holds one case against the reference, which runs in this process on the
same params (bridged), prompts and frames.  The ranks import only torch and
the port.

Configs, reduced and float32: tinyllama-1.1b, deepseek-moe-16b at capacity
factor 16 (nothing drops, so the one-pass prefill equals the reference's
token-by-token one, as ``tests/test_torch_moe.py`` holds it), rwkv6-3b,
zamba2-2.7b with 4 layers (two groups), whisper-base on 20 frames against
a 16-token prompt, phi-3-vision-4.2b; and tinyllama with a sliding window
of 8, whose rolling cache (8 slots, 2 a rank on (1, 4)) is shorter than the
prompt.  Each on (data 2, model 2) and (data 1, model 4): a prompt of 4 ×
16 into caches of 24 slots, then 3 decode steps fed the reference's greedy
tokens.  Tolerances: the prefill's last logits and every step's logits
1e-4 against the reference's ``prefill`` / ``decode_step``; the port's
greedy tokens (``serve.decode.greedy`` on the vocab-split logits) equal
the reference's argmax; every tensor of the decode state takes the
placements of ``launch.dryrun.decode_state_specs`` on the rank's view.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCHS = {"tinyllama-1.1b": dict(dtype="float32"),
         "deepseek-moe-16b": dict(dtype="float32", moe_capacity_factor=16.0),
         "rwkv6-3b": dict(dtype="float32"),
         "zamba2-2.7b": dict(dtype="float32", num_layers=4),
         "whisper-base": dict(dtype="float32"),
         "phi-3-vision-4.2b": dict(dtype="float32"),
         "tinyllama-swa": dict(dtype="float32", sliding_window=8)}
MESHES = [(2, 2), (1, 4)]
BATCH, PROMPT, MAX_LEN, FRAMES, STEPS = 4, 16, 24, 20, 3


def _arch(name):
    return "tinyllama-1.1b" if name == "tinyllama-swa" else name


# ---------------------------------------------------------------------------
# the ranks' side (torch and the port only)
# ---------------------------------------------------------------------------

def _port_cfg(name):
    from repro_torch import configs
    return configs.reduced(configs.get_config(_arch(name)), **ARCHS[name])


def _serve_case(cfg, params_np, case, mesh):
    from repro_torch import bridge
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch.dryrun import decode_state_specs
    from repro_torch.parallel.sharding import make_context
    from repro_torch.serve.decode import decode_step, greedy, prefill
    ctx = make_context(mesh, cfg, RunConfig())
    params = bridge.place_params(bridge.params_from_numpy(
        params_np, device="cpu"), cfg, ctx.mesh)
    frames = case.get("frames")
    with torch.no_grad():
        logits, state = prefill(
            params, cfg, torch.as_tensor(case["tokens"]), MAX_LEN, ctx=ctx,
            frame_embeds=None if frames is None else torch.as_tensor(frames))
        _, specs = decode_state_specs(cfg, ShapeConfig("serve", MAX_LEN,
                                                       BATCH, "decode"),
                                      ctx.mesh)
        placements = {n: (str(tuple(t.placements)),
                          str(tuple(specs[n].placements)))
                      for n, t in state.items() if hasattr(t, "placements")}
        out, tokens = [logits.full_tensor().numpy()], []
        for nxt in case["feed"]:
            tokens.append(greedy(logits, ctx).full_tensor().numpy())
            logits, state = decode_step(params, cfg,
                                        torch.as_tensor(nxt), state, ctx=ctx)
            out.append(logits.full_tensor().numpy())
    return {"logits": out, "greedy": tokens, "placements": placements,
            "cache_len": state["cache_len"],
            "view": tuple(ctx.mesh.mesh.shape)}


def _rank_all(rank, world, payload):
    import logging

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.testing import gloo_cuda
    gloo_cuda.use_c10d_collectives()
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    meshes = {shape: make_smoke_mesh(shape, device="cpu")
              for shape in MESHES}
    out = {}
    for name in ARCHS:
        cfg = _port_cfg(name)
        for shape in MESHES:
            out[(name, shape)] = _serve_case(
                cfg, payload["params"][name], payload["cases"][name],
                meshes[shape])
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


def _reference(cfg, params_np, tokens, frames):
    """The reference's prefill and decode steps, each step fed its own
    greedy token: (logits of the prefill and each step, the tokens fed)."""
    jax, jnp = _jax()
    from repro.serve import decode as JD
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    logits, state = JD.prefill(
        params, cfg, jnp.asarray(tokens, jnp.int32), MAX_LEN,
        frame_embeds=None if frames is None else jnp.asarray(frames))
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
    tmp = tmp_path_factory.mktemp("dist-serve")
    payload = {"params": {}, "cases": {}}
    want = {}
    for name in ARCHS:
        cfg = _ref_cfg(name)
        params = jax.tree_util.tree_map(
            np.asarray, JT.init_lm(cfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))
        frames = (rng.normal(size=(BATCH, FRAMES, cfg.d_model)).astype(
            np.float32) if cfg.is_encoder_decoder else None)
        logits, feed = _reference(cfg, params, tokens, frames)
        payload["params"][name] = params
        payload["cases"][name] = {"tokens": tokens, "feed": feed,
                                  **({} if frames is None else
                                     {"frames": frames})}
        want[name] = logits
    out = run_ranks(_rank_all, 4, (payload,), workdir=tmp, timeout=600)[0]
    return payload, want, out


def _case_id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("mesh", MESHES, ids=_case_id)
@pytest.mark.parametrize("name", list(ARCHS))
def test_sharded_prefill_and_decode_match_reference(group, name, mesh):
    """The prefill's last logits and 3 decode steps' logits within 1e-4 of
    the reference's; the port's greedy token from the vocab-split logits is
    the reference's argmax at each step."""
    payload, want, out = group
    got = out[(name, mesh)]
    assert got["view"][0] == mesh[0]
    assert got["view"][1] * got["view"][2] == mesh[1]
    assert len(got["logits"]) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["logits"], want[name])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} step {i}")
    for g, w in zip(got["greedy"], payload["cases"][name]["feed"]):
        np.testing.assert_array_equal(g, w)
    assert got["cache_len"] == PROMPT + STEPS


@pytest.mark.parametrize("mesh", MESHES, ids=_case_id)
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_state_takes_the_spec_layout(group, name, mesh):
    """Every tensor of the decode state is a DTensor with the placements of
    ``decode_state_specs`` on the view; the caches' slots split over tp
    (24 slots, the rolling window's 8, all divide 4)."""
    _, _, out = group
    got = out[(name, mesh)]["placements"]
    assert got
    for key, (have, spec) in got.items():
        assert have == spec, key
    for key in ("k_cache", "cross_k", "k_cache_dense"):
        if key in got:
            assert "Shard(dim=2)" in got[key][0], key
