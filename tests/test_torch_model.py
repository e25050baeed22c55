"""Port vs reference: the LM forward on the reference's own params.

JAX ``init_lm`` params of ``reduced(tinyllama-1.1b)`` (dense) and
``reduced(rwkv6-3b)`` (ssm) go through ``bridge.params_from_numpy`` into the
port.  Float32 logits agree within
1e-4 (the same float32 formulas; the attention is the kernel's plain
version against ``blocked_attention``, which sums in another order).  In
bf16 both round activations at every layer, in places that differ (the
port keeps P in float32 for the PV product, ``blocked_attention`` rounds it
to bf16), so the bound is the serving tests' atol 0.15 / rtol 0.05.
The ssm forward runs the recurrence's plain version against the reference's
jnp chunked scan, the same float32 formulas: 1e-4; bf16 0.15 / 0.05.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge, configs as tcfg  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


def _jax_params(cfg):
    return jax.tree_util.tree_map(np.asarray,
                                  JT.init_lm(cfg, jax.random.PRNGKey(0)))


def _cfgs(dtype, arch="tinyllama-1.1b"):
    jc = jcfg.reduced(jcfg.get_config(arch), dtype=dtype)
    tc = tcfg.reduced(tcfg.get_config(arch), dtype=dtype)
    return jc, tc


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("make", [
    lambda m: m.get_config("tinyllama-1.1b"),
    lambda m: m.reduced(m.get_config("tinyllama-1.1b")),
    lambda m: m.reduced(m.get_config("tinyllama-1.1b"), dtype="float32",
                        num_layers=3),
    lambda m: m.get_config("rwkv6-3b"),
    lambda m: m.reduced(m.get_config("rwkv6-3b")),
    lambda m: m.reduced(m.get_config("rwkv6-3b"), dtype="float32"),
    lambda m: m.get_config("olmo-1b"),
    lambda m: m.reduced(m.get_config("olmo-1b"), dtype="float32"),
    lambda m: m.get_config("qwen1.5-32b"),
    lambda m: m.reduced(m.get_config("qwen1.5-32b"), dtype="float32"),
    lambda m: m.get_config("nemotron-4-340b"),
    lambda m: m.reduced(m.get_config("nemotron-4-340b"), dtype="float32"),
    lambda m: m.get_config("deepseek-moe-16b"),
    lambda m: m.reduced(m.get_config("deepseek-moe-16b"), dtype="float32"),
    lambda m: m.get_config("mixtral-8x22b"),
    lambda m: m.reduced(m.get_config("mixtral-8x22b"), dtype="float32"),
    lambda m: m.get_config("zamba2-2.7b"),
    lambda m: m.reduced(m.get_config("zamba2-2.7b"), dtype="float32",
                        num_layers=4),
    lambda m: m.get_config("whisper-base"),
    lambda m: m.reduced(m.get_config("whisper-base"), dtype="float32"),
    lambda m: m.get_config("phi-3-vision-4.2b"),
    lambda m: m.reduced(m.get_config("phi-3-vision-4.2b"), dtype="float32"),
    lambda m: m.reduced(m.get_config("phi-3-vision-4.2b"), head_dim=96),
], ids=["full", "reduced", "reduced-f32", "rwkv6-full", "rwkv6-reduced",
        "rwkv6-reduced-f32", "olmo-full", "olmo-reduced-f32", "qwen-full",
        "qwen-reduced-f32", "nemotron-full", "nemotron-reduced-f32",
        "deepseek-full", "deepseek-reduced-f32", "mixtral-full",
        "mixtral-reduced-f32", "zamba2-full", "zamba2-reduced-f32",
        "whisper-full", "whisper-reduced-f32", "phi3-full",
        "phi3-reduced-f32", "phi3-reduced-hd96"])
def test_config_copy_matches_reference(make):
    ref, port = make(jcfg), make(tcfg)
    names = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(port)] == names
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    assert port.head_dim_ == ref.head_dim_
    assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("make", [
    lambda m: m.RunConfig(),
    lambda m: m.RunConfig(remat="none", sequence_parallel=False,
                          microbatch=4, grad_compression=True, ssm_chunk=64,
                          param_dtype="bfloat16",
                          logical_axis_overrides=(("sp", "data"),)),
    *(lambda m, n=n: m.SHAPES[n] for n in ("train_4k", "prefill_32k",
                                           "decode_32k", "long_500k")),
    lambda m: m.ShapeConfig("t", 256, 8, "train"),
], ids=["run-defaults", "run-set", "train_4k", "prefill_32k", "decode_32k",
        "long_500k", "shape-small"])
def test_run_and_shape_configs_match_reference(make):
    """``RunConfig``, ``ShapeConfig`` and ``SHAPES`` field for field, with
    the same defaults, and the same ``SHAPES`` keys."""
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    ref, port = make(jbase), make(tbase)
    names = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(port)] == names
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    assert list(tbase.SHAPES) == list(jbase.SHAPES)
    assert [f.default for f in dataclasses.fields(tbase.RunConfig)] == [
        f.default for f in dataclasses.fields(jbase.RunConfig)]


@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 1e-4, 1e-4),
                                             ("bfloat16", 0.15, 0.05)])
def test_forward_matches_reference(dtype, atol, rtol):
    jc, tc = _cfgs(dtype)
    npp = _jax_params(jc)
    toks = _tokens(jc)
    ref, ref_aux = JT.forward(jax.tree_util.tree_map(jnp.asarray, npp), jc,
                              jnp.asarray(toks, jnp.int32))
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    out = lm(torch.as_tensor(toks))
    assert out.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)
    # the functional forward returns (logits, aux) like the reference
    logits, aux = TT.forward(lm.compute_params(), tc, torch.as_tensor(toks))
    assert torch.equal(logits, out)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert aux.item() == float(ref_aux) == 0.0


def test_params_round_trip_exact():
    jc, _ = _cfgs("float32")
    npp = _jax_params(jc)
    back = bridge.params_to_numpy(bridge.params_from_numpy(npp, device="cpu"))
    flat = jax.tree_util.tree_leaves_with_path(npp)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        assert node.dtype == leaf.dtype and np.array_equal(node, leaf), path


def test_bf16_bridge_round_trip_is_exact_on_bf16_values():
    npp = {"w": np.asarray(jnp.asarray(
        np.random.default_rng(0).normal(size=(4, 8)), jnp.bfloat16),
        np.float32)}
    t = bridge.params_from_numpy(npp, device="cpu", dtype=torch.bfloat16)
    assert t["w"].dtype == torch.bfloat16
    assert np.array_equal(bridge.params_to_numpy(t)["w"], npp["w"])


def test_port_init_has_reference_layout():
    jc, tc = _cfgs("float32")
    ref = _jax_params(jc)
    port = bridge.params_to_numpy(TT.init_lm(tc, seed=0, device="cpu"))
    jshapes = jax.tree_util.tree_map(np.shape, ref)
    pshapes = jax.tree_util.tree_map(np.shape, port)
    assert pshapes == jshapes


def test_compute_params_keep_norms_f32_and_cast_matrices():
    _, tc = _cfgs("bfloat16")
    lm = TT.LM.init(tc, seed=3, device="cpu")
    cp = lm.compute_params()
    assert cp["layers"]["ln1"]["scale"].dtype == torch.float32
    assert cp["ln_f"]["scale"].dtype == torch.float32
    for w in (cp["embed"], cp["lm_head"], cp["layers"]["attn"]["wq"],
              cp["layers"]["mlp"]["w_down"]):
        assert w.dtype == torch.bfloat16
    assert torch.equal(cp["layers"]["attn"]["wo"],
                       lm.params["layers"]["attn"]["wo"].to(torch.bfloat16))
    assert lm.compute_params() is cp          # made once


UNPORTED = (r"the audio family \(slice 5c\) as an encoder-decoder on "
            r"frame embeddings and the vlm family \(slice 5d\) as a "
            r"decoder on patch embeddings")


@pytest.mark.parametrize("arch_family", ["vlm", "audio"])
def test_unported_families_raise(arch_family):
    """The vlm family, which slice 5d ports, inits and runs forward on patch
    embeddings, and only as a decoder with a "patch" frontend; the audio
    family, which slice 5c ports, on frame embeddings, and only as an
    encoder-decoder on frames.  Every other combination is refused."""
    if arch_family == "vlm":
        cfg = tcfg.reduced(tcfg.get_config("phi-3-vision-4.2b"))
        lm = TT.LM.init(cfg, seed=0, device="cpu")
        logits, aux = TT.forward(
            lm.compute_params(), cfg, torch.zeros(2, 20, dtype=torch.long),
            patch_embeds=torch.full((2, cfg.num_patches, cfg.d_model), 0.01))
        assert tuple(logits.shape) == (2, 20, cfg.vocab_size)
        assert logits.dtype == torch.bfloat16 and aux.item() == 0.0
        assert bool(torch.isfinite(logits.float()).all())
        for bad in (dict(frontend=None), dict(frontend="frames"),
                    dict(is_encoder_decoder=True, encoder_layers=2)):
            with pytest.raises(NotImplementedError, match=UNPORTED):
                TT.init_lm(dataclasses.replace(cfg, **bad), device="cpu")
            with pytest.raises(NotImplementedError, match=UNPORTED):
                TT.forward({}, dataclasses.replace(cfg, **bad),
                           torch.zeros(1, 4, dtype=torch.long))
        return
    cfg = tcfg.reduced(tcfg.get_config("whisper-base"))
    lm = TT.LM.init(cfg, seed=0, device="cpu")
    logits, aux = TT.forward(lm.compute_params(), cfg,
                             torch.zeros(2, 7, dtype=torch.long),
                             frame_embeds=torch.full((2, 9, cfg.d_model),
                                                     0.01))
    assert tuple(logits.shape) == (2, 7, cfg.vocab_size)
    assert logits.dtype == torch.bfloat16 and aux.item() == 0.0
    assert bool(torch.isfinite(logits.float()).all())
    for bad in (dict(frontend=None), dict(frontend="patch"),
                dict(is_encoder_decoder=False)):
        with pytest.raises(NotImplementedError, match=UNPORTED):
            TT.init_lm(dataclasses.replace(cfg, **bad), device="cpu")


def test_ssm_family_runs():
    """The ssm family, which slice 3 ports, inits and runs forward."""
    _, tc = _cfgs("bfloat16", "rwkv6-3b")
    lm = TT.LM.init(tc, seed=0, device="cpu")
    logits, aux = TT.forward(lm.compute_params(), tc,
                             torch.zeros(2, 7, dtype=torch.long))
    assert tuple(logits.shape) == (2, 7, tc.vocab_size)
    assert logits.dtype == torch.bfloat16 and aux.item() == 0.0
    assert bool(torch.isfinite(logits.float()).all())


def test_hybrid_family_runs():
    """The hybrid family, which slice 5b ports, inits and runs forward; a
    depth that is not a multiple of ``attn_every`` is refused, as the
    reference's reshape into groups refuses it."""
    tc = tcfg.reduced(tcfg.get_config("zamba2-2.7b"), num_layers=4)
    lm = TT.LM.init(tc, seed=0, device="cpu")
    logits, aux = TT.forward(lm.compute_params(), tc,
                             torch.zeros(2, 7, dtype=torch.long))
    assert tuple(logits.shape) == (2, 7, tc.vocab_size)
    assert logits.dtype == torch.bfloat16 and aux.item() == 0.0
    assert bool(torch.isfinite(logits.float()).all())
    with pytest.raises(ValueError, match="multiple of attn_every"):
        TT.init_lm(dataclasses.replace(tc, num_layers=5), device="cpu")


@pytest.mark.parametrize("s", [24, 13], ids=["chunk-8", "chunk-13"])
@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 1e-4, 1e-4),
                                             ("bfloat16", 0.15, 0.05)])
def test_ssm_forward_matches_reference(dtype, atol, rtol, s):
    jc, tc = _cfgs(dtype, "rwkv6-3b")
    npp = _jax_params(jc)
    toks = _tokens(jc, s=s)
    ref, ref_aux = JT.forward(jax.tree_util.tree_map(jnp.asarray, npp), jc,
                              jnp.asarray(toks, jnp.int32))
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    out = lm(torch.as_tensor(toks))
    assert out.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)
    assert float(ref_aux) == 0.0


def test_ssm_port_init_has_reference_layout():
    jc, tc = _cfgs("float32", "rwkv6-3b")
    ref = _jax_params(jc)
    port = bridge.params_to_numpy(TT.init_lm(tc, seed=0, device="cpu"))
    assert (jax.tree_util.tree_map(np.shape, port)
            == jax.tree_util.tree_map(np.shape, ref))
    assert (jax.tree_util.tree_map(lambda a: a.dtype, port)
            == jax.tree_util.tree_map(lambda a: a.dtype, ref))
    tm = port["layers"]["tmix"]
    assert (tm["decay_base"] == -0.5).all() and (tm["mix_x"] == 0.5).all()
    assert (port["layers"]["cmix"]["mix"] == 0.5).all()


# ---------------------------------------------------------------------------
# empty parameter subtrees: nonparam_ln (olmo-1b) has {} for every norm
# ---------------------------------------------------------------------------

def _olmo():
    """Reduced float32 olmo-1b: the reference's config, its params, and the
    port's registered copy of the config."""
    jc, tc = _cfgs("float32", "olmo-1b")
    assert tc.norm == "nonparam_ln"
    return jc, tc, _jax_params(jc)


def test_port_registers_the_dense_family():
    """Every config of the reference, the dense family among them."""
    assert {"tinyllama-1.1b", "olmo-1b", "qwen1.5-32b",
            "nemotron-4-340b"} < set(tcfg.list_configs())
    assert tcfg.list_configs() == jcfg.list_configs()


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen1.5-32b",
                                  "nemotron-4-340b"])
def test_dense_configs_forward_matches_reference(arch):
    """The rest of the dense family, reduced, float32, through ``LM``:
    1e-4, as tinyllama's."""
    jc, tc = _cfgs("float32", arch)
    npp = _jax_params(jc)
    toks = _tokens(jc)
    ref, _ = JT.forward(jax.tree_util.tree_map(jnp.asarray, npp), jc,
                        jnp.asarray(toks, jnp.int32))
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    np.testing.assert_allclose(lm(torch.as_tensor(toks)).numpy(),
                               np.asarray(ref, np.float32), atol=1e-4,
                               rtol=1e-4)


def test_lm_keeps_empty_subtrees():
    """``LM.params`` and ``compute_params()`` give ``ln1`` / ``ln2`` /
    ``ln_f`` back as {}, as the reference's tree has them."""
    _, tc, npp = _olmo()
    assert npp["ln_f"] == {} and npp["layers"]["ln1"] == {}
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    for tree in (lm.params, lm.compute_params()):
        assert tree["ln_f"] == {}
        assert tree["layers"]["ln1"] == tree["layers"]["ln2"] == {}
    assert (jax.tree_util.tree_map(np.shape, bridge.params_to_numpy(
        lm.params)) == jax.tree_util.tree_map(np.shape, npp))
    # and through .to(), which remakes the compute copy
    assert lm.to("cpu").compute_params()["ln_f"] == {}


def test_lm_forward_matches_reference_on_nonparam_ln():
    jc, tc, npp = _olmo()
    toks = _tokens(jc)
    ref, _ = JT.forward(jax.tree_util.tree_map(jnp.asarray, npp), jc,
                        jnp.asarray(toks, jnp.int32))
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    out = lm(torch.as_tensor(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               atol=1e-4, rtol=1e-4)


def test_lm_generate_gives_reference_greedy_tokens_on_nonparam_ln():
    from repro.serve import decode as JD
    from repro_torch.launch.serve import generate
    jc, tc, npp = _olmo()
    toks = _tokens(jc, s=10, seed=3)
    gen = 5
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    logits, st = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32),
                            toks.shape[1] + gen)
    want = []
    for i in range(gen):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
        if i < gen - 1:
            logits, st = JD.decode_step(jp, jc, tok, st)
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    res = generate(lm, torch.as_tensor(toks), gen)
    assert np.array_equal(res.tokens.numpy(), np.concatenate(want, axis=1))
    np.testing.assert_allclose(res.last_logits.numpy(),
                               np.asarray(logits, np.float32), atol=1e-4,
                               rtol=1e-4)
