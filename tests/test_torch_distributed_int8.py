"""The int8 AdamW state under a mesh against the reference's single device.

One group of 4 gloo ranks on the CPU (``repro_torch.testing.run_ranks``)
runs, on each of the meshes (2, 2), (1, 4) and (4, 1), three
``adamw_update`` steps with ``state_dtype="int8"`` from a zero state on a
tree of leaves laid out to cover each case of the layout
(``train/optimizer.py::int8_layout``): a last axis split into shards whose
widths are multiples of 128 (the split moves to the blocks), split into
shards that are not (each rank keeps whole rows; padding of the last block
included), a leaf under 128 values (float32 state, as the reference keeps
it), a leaf of 256 values whose shard on 4 ranks is 64 (int8, decided on
the global size), leading dims split.  The reference runs
``repro.train.optimizer.adamw_update`` on the same params and grads in this
process: every int8 ``q`` bit-identical, every ``scale`` exact, params
within 1e-6.  The grads keep the global norm under ``clip_norm``, so both
packages scale them by exactly 1.

Then a sharded int8 state saved on (2, 2) is restored on (1, 4) and with no
mesh, ``q`` bit-exact, and the reference's ``ckpt.restore`` reads it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MESHES = [(2, 2), (1, 4), (4, 1)]
STEPS = 3
LR = 1e-3
# leaf: (shape, spec over ("data", "model"))
LEAVES = {
    "aligned": ((3, 1024), (None, ("data", "model"))),
    "unaligned": ((4, 6, 200), ("data", None, "model")),
    "small": ((100,), (None,)),
    "small_shard": ((256,), (("data", "model"),)),
    "lead_split": ((8, 512), ("data", "model")),
    "vector": ((512,), ("model",)),
}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    out = {n: (rng.standard_normal(shape) * 0.002).astype(np.float32)
           for n, (shape, _) in LEAVES.items()}
    assert np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in out.values())) < 1.0
    return out


def _params():
    rng = np.random.default_rng(7)
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n, (shape, _) in LEAVES.items()}


# ---------------------------------------------------------------------------
# the ranks' side (torch and the port only)
# ---------------------------------------------------------------------------

def _place(tree, mesh, specs):
    from repro_torch.parallel.sharding import (P, compute_mesh,
                                               distribute_local,
                                               spec_placements)
    return {n: distribute_local(torch.as_tensor(x), compute_mesh(mesh),
                                spec_placements(P(*specs[n]), mesh))
            for n, x in tree.items()}


def _rank_int8(rank, world, payload):
    import logging

    from repro_torch import bridge
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import P, NamedSharding
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                             adamw_update, int8_layout)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    specs = {n: spec for n, (_, spec) in LEAVES.items()}
    cfg = OptimizerConfig(lr=LR, warmup_steps=0, state_dtype="int8")
    out = {}
    for shape in MESHES:
        mesh = make_smoke_mesh(shape, device="cpu")
        params = _place(payload["params"], mesh, specs)
        state = adamw_init(params, cfg)
        for s in range(STEPS):
            grads = _place(payload["grads"][s], mesh, specs)
            params, state, _ = adamw_update(grads, state, params, cfg)
        out[shape] = {
            "params": {n: x.full_tensor().numpy() for n, x in params.items()},
            "state": bridge.opt_state_to_numpy(state),
            "layouts": {n: (str(tuple(x.placements)),
                            str(tuple(int8_layout(
                                x.shape, x.device_mesh, x.placements))))
                        for n, x in params.items()},
            "q_local": {n: tuple(state.m[n][0].to_local().shape)
                        for n in params if isinstance(state.m[n], tuple)}}
        if shape == (2, 2):
            ckpt.save(payload["ckpt_dir"], 1, params, state)
            saved_state = state
    # restore the (2, 2) checkpoint on (1, 4) and with no mesh
    full = {n: torch.as_tensor(x) for n, x in payload["params"].items()}
    mesh14 = make_smoke_mesh((1, 4), device="cpu")
    shard14 = {n: NamedSharding(mesh14, P(*specs[n])) for n in specs}
    p14, o14, _ = ckpt.restore(payload["ckpt_dir"], 1, full,
                               adamw_init(full, cfg), shardings=shard14)
    plain_p, plain_o, _ = ckpt.restore(payload["ckpt_dir"], 1, full,
                                       adamw_init(full, cfg))
    out["restored14"] = bridge.opt_state_to_numpy(o14)
    out["restored14_layout"] = {
        n: str(o14.m[n][0].placements) for n in specs
        if isinstance(o14.m[n], tuple)}
    out["restored14_params"] = {n: x.full_tensor().numpy()
                                for n, x in p14.items()}
    out["restored_plain"] = bridge.opt_state_to_numpy(plain_o)
    out["restored_plain_q_shape"] = {
        n: tuple(plain_o.m[n][0].shape) for n in specs
        if isinstance(plain_o.m[n], tuple)}
    out["saved"] = bridge.opt_state_to_numpy(saved_state)
    # the bridge lays a gathered state out on a mesh again
    params22 = _place(payload["params"], make_smoke_mesh((2, 2),
                                                         device="cpu"),
                      specs)
    back = bridge.opt_state_from_numpy(out["saved"], device="cpu",
                                       params=params22)
    out["bridged_back"] = bridge.opt_state_to_numpy(back)
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _reference_steps(params, grads):
    import jax.numpy as jnp
    from repro.train import optimizer as jopt
    cfg = jopt.OptimizerConfig(lr=LR, warmup_steps=0, state_dtype="int8")
    p = {n: jnp.asarray(x) for n, x in params.items()}
    st = jopt.adamw_init(p, cfg)
    for s in range(STEPS):
        p, st, _ = jopt.adamw_update({n: jnp.asarray(g) for n, g in
                                      grads[s].items()}, st, p, cfg)
    return ({n: np.asarray(x) for n, x in p.items()},
            {k: (tuple(np.asarray(t) for t in v) if isinstance(v, tuple)
                 else np.asarray(v)) for k, v in st.m.items()},
            {k: (tuple(np.asarray(t) for t in v) if isinstance(v, tuple)
                 else np.asarray(v)) for k, v in st.v.items()}, cfg)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from repro_torch.testing import run_ranks
    tmp = tmp_path_factory.mktemp("int8")
    payload = {"params": _params(),
               "grads": [_grads(s) for s in range(STEPS)],
               "ckpt_dir": str(tmp / "ckpt")}
    out = run_ranks(_rank_int8, 4, (payload,), workdir=tmp, timeout=600)[0]
    return payload, out, _reference_steps(payload["params"],
                                          payload["grads"])


def _same_state(got_m, want_m):
    for n, want in want_m.items():
        got = got_m[n]
        assert isinstance(got, tuple) == isinstance(want, tuple), n
        if isinstance(want, tuple):
            assert got[0].dtype == np.int8 and got[0].shape == want[0].shape
            np.testing.assert_array_equal(got[0], want[0], err_msg=n)
            np.testing.assert_array_equal(got[1], want[1], err_msg=n)
        else:
            np.testing.assert_array_equal(got, want, err_msg=n)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_int8_state_matches_reference(group, mesh):
    _, out, (want_p, want_m, want_v, _) = group
    got = out[mesh]
    _same_state(got["state"].m, want_m)
    _same_state(got["state"].v, want_v)
    for n, want in want_p.items():
        np.testing.assert_allclose(got["params"][n], want, atol=1e-6,
                                   rtol=0, err_msg=n)


def test_int8_layout_cases(group):
    """Which leaves are int8 and how their state is laid out: the aligned
    split moves to the blocks; the unaligned and the 64-value shards keep
    whole rows; the 100-value leaf stays float32."""
    _, out, (_, want_m, _, _) = group
    assert not isinstance(want_m["small"], tuple)
    assert isinstance(want_m["small_shard"], tuple)
    layouts = out[(2, 2)]["layouts"]
    q_local = out[(2, 2)]["q_local"]
    # 1024 over 4 ranks: 256 = 2 blocks a rank
    assert q_local["aligned"] == (3, 2, 128)
    assert layouts["aligned"][0] == layouts["aligned"][1]
    # 200 over "model" (2): 100 a shard, so whole rows of 2 blocks
    assert q_local["unaligned"] == (2, 6, 2, 128)
    assert layouts["unaligned"][0] != layouts["unaligned"][1]
    # 256 over 4 ranks is 64 a shard: int8 all the same, whole rows
    assert q_local["small_shard"] == (2, 128)
    assert q_local["lead_split"] == (4, 2, 128)
    assert "small" not in q_local
    assert out[(1, 4)]["q_local"]["vector"] == (1, 128)


def test_int8_checkpoint_restores_on_another_mesh_and_none(group):
    payload, out, (_, want_m, _, cfg) = group
    _same_state(out["restored14"].m, out["saved"].m)
    _same_state(out["restored14"].v, out["saved"].v)
    _same_state(out["restored_plain"].m, out["saved"].m)
    _same_state(out["bridged_back"].m, out["saved"].m)
    _same_state(out["bridged_back"].v, out["saved"].v)
    assert out["restored_plain_q_shape"]["unaligned"] == (24, 2, 128)
    assert "Shard" in out["restored14_layout"]["aligned"]
    for n, x in out["restored14_params"].items():
        np.testing.assert_array_equal(x, out[(2, 2)]["params"][n])
    # the reference reads the port's sharded int8 checkpoint
    import jax.numpy as jnp
    from repro.train import checkpoint as jckpt
    from repro.train import optimizer as jopt
    template = {n: jnp.asarray(x) for n, x in payload["params"].items()}
    _, jopt_state, _ = jckpt.restore(payload["ckpt_dir"], 1, template,
                                     jopt.adamw_init(template, cfg))
    for n, want in out["saved"].m.items():
        got = jopt_state.m[n]
        if isinstance(want, tuple):
            np.testing.assert_array_equal(np.asarray(got[0]), want[0])
            np.testing.assert_array_equal(np.asarray(got[1]), want[1])
        else:
            np.testing.assert_array_equal(np.asarray(got), want)
