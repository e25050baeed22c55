"""Port vs reference: the vlm family (phi-3-vision-4.2b, a decoder whose
first P token embeddings are replaced by stub patch embeddings projected
by ``patch_proj``) through ``models``, ``train`` and ``serve``.

Reduced phi-3-vision (2 layers, d_model 64, 4 heads of 16, vocab 256, 16
patches; one case at head_dim 96, phi-3's own); the reference's own
``init_lm`` params through ``bridge.params_from_numpy``; every input from
a numpy seed.  Float32 unless noted, with these tolerances:
* ``forward`` with 16 patches against a 24-token prompt, and with P = S:
  1e-4; in bf16 at the serving tests' 0.15 / 0.05, as the dense family's
  bf16 forward (``tests/test_torch_model.py``);
* ``lm_loss`` 1e-5 and every grad 1e-4 against ``jax.value_and_grad``,
  ``patch_proj``'s among them;
* the port's one-pass ``prefill`` against the reference's token-by-token
  ``prefill`` and three ``decode_step`` s: 1e-4, identical greedy tokens
  (the reference serves the vlm family on tokens alone, so does the port);
* P > S is refused (a ``ValueError``), where the reference's merged
  sequence is P long and its RoPE over S positions cannot broadcast;
* in the port alone: ``LM.forward(patch_embeds=)``, the bf16 compute copy
  of ``patch_proj``, decode against teacher forcing in bf16, the layout,
  the parameter count and ``launch.serve.main`` on the CPU.

    PYTHONPATH=src python -m pytest -q tests/test_torch_vlm.py
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro_torch import bridge, configs as tcfg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import decode as TD  # noqa: E402
from repro_torch.train.tree import flatten  # noqa: E402

ARCH = "phi-3-vision-4.2b"
BF16_ATOL, BF16_RTOL = 0.15, 0.05


def _cfgs(dtype="float32", **over):
    over = {"dtype": dtype, **over}
    return (jcfg.reduced(jcfg.get_config(ARCH), **over),
            tcfg.reduced(tcfg.get_config(ARCH), **over))


@functools.lru_cache(maxsize=None)
def _npp(head_dim=16):
    jc, _ = _cfgs(head_dim=head_dim)
    return jax.tree_util.tree_map(np.asarray,
                                  JT.init_lm(jc, jax.random.PRNGKey(0)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _patches(cfg, p=None, b=2, seed=2):
    return np.random.default_rng(seed).normal(
        size=(b, p or cfg.num_patches, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol, rtol=None):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol,
                               rtol=tol if rtol is None else rtol)


# ---------------------------------------------------------------------------
# config, layout
# ---------------------------------------------------------------------------

def test_param_count_and_head_dim():
    """Full width: 3,821,076,480 parameters by the analytic count (which,
    as the reference's, leaves ``patch_proj`` out), and 3072² more with
    it; head_dim 3072 / 32 = 96."""
    cfg = tcfg.get_config(ARCH)
    assert cfg.head_dim_ == 96 and cfg.num_patches == 256
    assert cfg.param_count() == 3_821_076_480
    assert cfg.param_count() + cfg.d_model ** 2 == 3_830_513_664


def test_port_init_has_reference_layout():
    _, tc = _cfgs()
    ref = _npp()
    port = bridge.params_to_numpy(TT.init_lm(tc, seed=0, device="cpu"))
    assert (jax.tree_util.tree_map(np.shape, port)
            == jax.tree_util.tree_map(np.shape, ref))
    assert (jax.tree_util.tree_map(lambda a: a.dtype, port)
            == jax.tree_util.tree_map(lambda a: a.dtype, ref))
    assert port["patch_proj"].shape == (tc.d_model, tc.d_model)
    assert abs(port["patch_proj"].std() * np.sqrt(tc.d_model) - 1) < 0.05


def test_compute_copy_casts_patch_proj():
    _, tc = _cfgs("bfloat16")
    lm = TT.LM.init(tc, seed=0, device="cpu")
    cp = lm.compute_params()
    assert cp["patch_proj"].dtype == torch.bfloat16
    assert torch.equal(cp["patch_proj"],
                       lm.params["patch_proj"].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# forward, loss, grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,s,p", [(16, 24, 16), (16, 16, 16),
                                          (96, 24, 16)],
                         ids=["p16-s24", "p-equals-s", "hd96"])
@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 1e-4, 1e-4),
                                             ("bfloat16", BF16_ATOL,
                                              BF16_RTOL)])
def test_forward_matches_reference(head_dim, s, p, dtype, atol, rtol):
    jc, tc = _cfgs(dtype, head_dim=head_dim)
    npp = _npp(head_dim)
    toks = _tokens(jc, s=s)
    pe = _patches(jc, p)
    ref, ref_aux = JT.forward(_jnp(npp), jc, jnp.asarray(toks, jnp.int32),
                              patch_embeds=jnp.asarray(pe))
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    logits, aux = TT.forward(lm.compute_params(), tc, torch.as_tensor(toks),
                             patch_embeds=torch.as_tensor(pe))
    assert logits.dtype == getattr(torch, dtype)
    assert tuple(logits.shape) == (2, s, tc.vocab_size)
    _close(logits, ref, atol, rtol)
    assert aux.item() == float(ref_aux) == 0.0


def test_lm_forward_takes_patch_embeds():
    """``LM.forward(patch_embeds=)`` is the functional forward; the patches
    reach every position (those past P through attention), and without
    them the tokens run alone, as the reference's forward does."""
    _, tc = _cfgs()
    lm = TT.LM(tc, bridge.params_from_numpy(_npp(), device="cpu"))
    toks = torch.as_tensor(_tokens(tc))
    pe = torch.as_tensor(_patches(tc))
    with_p = lm(toks, patch_embeds=pe)
    assert torch.equal(with_p, TT.forward(lm.compute_params(), tc, toks,
                                          patch_embeds=pe)[0])
    without = lm(toks)
    assert torch.equal(without, TT.forward(lm.compute_params(), tc,
                                           toks)[0])
    p = tc.num_patches
    assert (with_p[:, p:] - without[:, p:]).abs().amax(-1).min() > 1e-4


@pytest.mark.parametrize("s", [1, 8])
def test_more_patches_than_tokens_are_refused(s):
    """P > S: the reference's merged sequence is P long against S
    positions, which its RoPE cannot broadcast for 1 < S < P (a
    ``TypeError``) and for S = 1 broadcasts position 0 over P rows; the
    port refuses both (ROADMAP.md, deliberate differences)."""
    jc, tc = _cfgs()
    toks, pe = _tokens(jc, s=s), _patches(jc)
    if s > 1:
        with pytest.raises(TypeError):
            JT.forward(_jnp(_npp()), jc, jnp.asarray(toks, jnp.int32),
                       patch_embeds=jnp.asarray(pe))
    params = bridge.params_from_numpy(_npp(), device="cpu")
    with pytest.raises(ValueError, match="P <= S"):
        TT.forward(params, tc, torch.as_tensor(toks),
                   patch_embeds=torch.as_tensor(pe))


def test_lm_loss_and_grads_match_reference():
    jc, tc = _cfgs()
    npp = _npp()
    toks = _tokens(jc, s=25, seed=7).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    pe = _patches(jc, seed=8)

    def jloss(p):
        return JT.lm_loss(p, jc, jnp.asarray(tokens), jnp.asarray(labels),
                          patch_embeds=jnp.asarray(pe))
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(_jnp(npp))
    params = bridge.params_from_numpy(npp, device="cpu")
    leaves = flatten(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    loss, aux = TT.lm_loss(params, tc, torch.from_numpy(tokens).long(),
                           torch.from_numpy(labels).long(),
                           patch_embeds=torch.as_tensor(pe))
    grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves])
    assert abs(loss.item() - float(jl)) <= 1e-5
    assert abs(aux["nll"].item() - float(jaux["nll"])) <= 1e-5
    want = {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert sorted(want) == [path for path, _ in leaves]
    for (path, _), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[path], atol=1e-4,
                                   rtol=1e-4, err_msg=path)
    assert np.abs(want["patch_proj"]).max() > 1e-4


# ---------------------------------------------------------------------------
# serving: prefill, decode, generate (tokens alone, as the reference)
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_reference():
    jc, tc = _cfgs()
    npp = _npp()
    jp, tp = _jnp(npp), bridge.params_from_numpy(npp, device="cpu")
    toks = _tokens(jc, s=10, seed=6)
    jl, jst = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32), 16)
    tl, tst = TD.prefill(tp, tc, torch.as_tensor(toks), 16)
    _close(tl, jl, 1e-4)
    for name in ("k_cache", "v_cache"):
        _close(tst[name][:, :, :10], jst[name][:, :, :10], 1e-4)
    for _ in range(3):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(dim=-1)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jst = JD.decode_step(jp, jc, jtok, jst)
        tl, tst = TD.decode_step(tp, tc, ttok, tst)
        _close(tl, jl, 1e-4)
    assert np.array_equal(tl.argmax(dim=-1).numpy(),
                          np.asarray(jnp.argmax(jl, axis=-1)))
    assert tst["cache_len"] == int(jst["cache_len"]) == 13
    assert set(tst) == set(jst)


def test_decode_matches_teacher_forced_forward_bf16():
    """In the port alone, bf16: the last decode logits against a forward
    over prompt + generated tokens (``tests/test_serve.py``'s tolerance)."""
    _, tc = _cfgs("bfloat16")
    lm = TT.LM(tc, bridge.params_from_numpy(_npp(), device="cpu"))
    prompts = tserve.make_prompts(tc, 2, 12, seed=4, device="cpu")
    res = tserve.generate(lm, prompts, gen=5)
    full = lm(torch.cat([prompts, res.tokens[:, :-1]], dim=1))
    _close(res.last_logits[:, 0], full[:, -1], BF16_ATOL, BF16_RTOL)
    assert res.tokens.shape == (2, 5)


def test_serve_main_runs_phi3_on_cpu(capsys):
    fa.launches = 3
    res = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert res.tokens.shape == (4, 4)
    assert "phi-3-vision-4.2b on cpu" in out
    assert "flash-attention kernel launches: 0" in out
    assert bool(torch.isfinite(res.last_logits.float()).all())
