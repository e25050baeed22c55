"""Port vs reference: the audio family (whisper-base, an encoder-decoder on
stub frame embeddings) through ``models`` and ``serve``.

Reduced whisper (2 encoder + 2 decoder layers, d_model 64, 4 heads of 16,
vocab 256); the reference's own ``init_lm`` params through
``bridge.params_from_numpy``; every input from a numpy seed.  Float32
unless noted, with these tolerances:
* ``sinusoidal_positions``: 1e-6 (the same float32 sin / cos); at
  whisper's 1500 frames 1500 * 2^-23 (one ulp of exp in a frequency,
  times the position);
* ``attention_block`` causal, non-causal, with ``kv_override`` (cross
  attention, Sq != Skv) and without RoPE: 2e-5 (the kernel's plain version
  against ``blocked_attention``, the same float32 sums in another order);
* ``forward`` with S_enc 10, 16 and 24 frames against a 16-token prompt:
  1e-4; in bf16 at the serving tests' 0.15 / 0.05
  (``tests/test_serve.py:60-62``), as ``test_forward_matches_reference``
  holds bf16: both round every activation to bf16, in places that differ
  (the port keeps P in float32 for the PV product);
* ``lm_loss`` 1e-5 and every grad 1e-4 against ``jax.value_and_grad``;
* the port's one-pass ``prefill`` against the reference's token-by-token
  ``prefill``, S_enc below, at and above ``max_len`` (the trim of rule
  (b)): last logits, ``cross_k`` / ``cross_v`` / ``enc_len`` (unclamped,
  rule (c)) and the self K/V caches, 1e-4 with float32 frames.  With bf16
  frames the encoder runs in bf16 on both sides (rule (a)), and the two
  bf16 encoders round in different places, as bf16 forwards do: the cross
  K/V (measured up to 0.031 apart) and the logits at 0.15 / 0.05; rule
  (a) itself is held exactly inside the port (the cached cross K/V equal
  the port's ``encode`` in the frames' dtype, cast to the state's);
* three ``decode_step`` s after the prefill: 1e-4, identical greedy
  tokens; ``generate`` gives the reference's greedy tokens;
* in the port alone, bf16: the last decode logits against the
  teacher-forced ``forward`` on the same frames, 0.15 / 0.05;
* the init's layout, and ``launch.serve.main`` on the CPU.

    PYTHONPATH=src python -m pytest -q tests/test_torch_audio.py
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import decode as JD  # noqa: E402
from repro_torch import bridge, configs as tcfg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rwkv6 as kr  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import decode as TD  # noqa: E402
from repro_torch.train.tree import flatten  # noqa: E402

ARCH = "whisper-base"
BF16_ATOL, BF16_RTOL = 0.15, 0.05
BF16_ULP = 8e-3


def _cfgs(dtype="float32", **over):
    over = {"dtype": dtype, **over}
    return (jcfg.reduced(jcfg.get_config(ARCH), **over),
            tcfg.reduced(tcfg.get_config(ARCH), **over))


@functools.lru_cache(maxsize=None)
def _npp(seed=0):
    jc, _ = _cfgs()
    return jax.tree_util.tree_map(np.asarray,
                                  JT.init_lm(jc, jax.random.PRNGKey(seed)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _frames(cfg, s_enc, b=2, seed=2):
    return np.random.default_rng(seed).normal(
        size=(b, s_enc, cfg.d_model)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol, rtol=None):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol,
                               rtol=tol if rtol is None else rtol)


def _as(frames, dtype):
    """numpy frames as (jax array, torch tensor) in ``dtype``."""
    jf = jnp.asarray(frames).astype(getattr(jnp, dtype))
    return jf, torch.as_tensor(frames).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# the pieces: positions, the attention block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d,tol", [(24, 64, 1e-6),
                                       (1500, 512, 1500 * 2.0 ** -23)])
def test_sinusoidal_positions_match_reference(seq, d, tol):
    """1e-6 at the reduced shape.  At whisper's 1500 frames: the two
    libraries' float32 exp may differ by one ulp in a frequency (<= 2^-23,
    the frequencies are <= 1), and position 1499 multiplies that into the
    angle, so sin / cos may differ by up to 1500 * 2^-23."""
    got = TC.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
    _close(got, JC.sinusoidal_positions(seq, d), tol, 0)


@pytest.mark.parametrize("mode", ["causal", "non-causal", "kv-override",
                                  "no-rope"])
def test_attention_block_matches_reference(mode):
    jc, tc = _cfgs()
    p = _npp()["cross_attn"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, jc.d_model)).astype(np.float32)
    pos = np.arange(3, 15)[None]
    kw = {"causal": mode != "non-causal", "use_rope": mode != "no-rope"}
    tkw = dict(kw)
    if mode == "kv-override":
        kv = [rng.normal(size=(2, 20, jc.num_kv_heads, jc.head_dim_)
                         ).astype(np.float32) for _ in range(2)]
        kw["kv_override"] = tuple(jnp.asarray(t) for t in kv)
        tkw["kv_override"] = tuple(torch.as_tensor(t) for t in kv)
    want = JA.attention_block(_jnp(p), jnp.asarray(x), jc,
                              positions=jnp.asarray(pos), **kw)
    got = TA.attention_block(bridge.params_from_numpy(p, device="cpu"),
                             torch.as_tensor(x), tc, torch.as_tensor(pos),
                             **tkw)
    _close(got, want, 2e-5)


def test_attention_block_positions_default_to_arange():
    jc, tc = _cfgs()
    p = {k: v[1] for k, v in _npp()["layers"]["attn"].items()}
    x = np.random.default_rng(4).normal(size=(2, 9, jc.d_model)
                                        ).astype(np.float32)
    want = JA.attention_block(_jnp(p), jnp.asarray(x), jc, causal=False)
    tp = bridge.params_from_numpy(p, device="cpu")
    got = TA.attention_block(tp, torch.as_tensor(x), tc, causal=False)
    _close(got, want, 2e-5)
    assert torch.equal(got, TA.attention_block(
        tp, torch.as_tensor(x), tc, torch.arange(9)[None], causal=False))


# ---------------------------------------------------------------------------
# the model: forward, loss and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_enc", [10, 16, 24])
@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 1e-4, 1e-4),
                                             ("bfloat16", BF16_ATOL,
                                              BF16_RTOL)])
def test_forward_matches_reference(s_enc, dtype, atol, rtol):
    jc, tc = _cfgs(dtype)
    npp = _npp()
    toks = _tokens(jc)
    frames = _frames(jc, s_enc)
    ref, ref_aux = JT.forward(_jnp(npp), jc, jnp.asarray(toks, jnp.int32),
                              frame_embeds=jnp.asarray(frames))
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    logits, aux = TT.forward(lm.compute_params(), tc, torch.as_tensor(toks),
                             frame_embeds=torch.as_tensor(frames))
    assert logits.dtype == getattr(torch, dtype)
    _close(logits, ref, atol, rtol)
    assert aux.item() == float(ref_aux) == 0.0
    assert torch.equal(lm(torch.as_tensor(toks), torch.as_tensor(frames)),
                       logits)


def test_forward_needs_frames():
    _, tc = _cfgs()
    lm = TT.LM.init(tc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="frame_embeds"):
        lm(torch.zeros(1, 4, dtype=torch.long))


def test_lm_loss_and_grads_match_reference():
    jc, tc = _cfgs()
    npp = _npp()
    toks = _tokens(jc, s=17, seed=7).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    frames = _frames(jc, 20, seed=8)

    def jloss(p):
        return JT.lm_loss(p, jc, jnp.asarray(tokens), jnp.asarray(labels),
                          frame_embeds=jnp.asarray(frames))
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(_jnp(npp))
    params = bridge.params_from_numpy(npp, device="cpu")
    leaves = flatten(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = TT.lm_loss(params, tc, torch.from_numpy(tokens).long(),
                         torch.from_numpy(labels).long(),
                         frame_embeds=torch.as_tensor(frames))
    grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves])
    assert abs(loss.item() - float(jl)) <= 1e-5
    want = {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert sorted(want) == [path for path, _ in leaves]
    for (path, _), g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[path], atol=1e-4,
                                   rtol=1e-4, err_msg=path)
    # the encoder and the cross attention get grads through the kernel's
    # Function at Sq != Skv
    for path in ("encoder_layers/attn/wq", "cross_attn/attn/wk"):
        assert np.abs(want[path]).max() > 1e-6, path


# ---------------------------------------------------------------------------
# serving: prefill, decode, generate
# ---------------------------------------------------------------------------

PROMPT, MAX_LEN = 6, 16


def _prefilled(s_enc, frame_dtype="float32", dtype="float32"):
    jc, tc = _cfgs(dtype)
    npp = _npp()
    jp, tp = _jnp(npp), bridge.params_from_numpy(npp, device="cpu")
    toks = _tokens(jc, s=PROMPT, seed=6)
    jf, tf = _as(_frames(jc, s_enc, seed=s_enc), frame_dtype)
    jl, jst = JD.prefill(jp, jc, jnp.asarray(toks, jnp.int32), MAX_LEN,
                         frame_embeds=jf)
    tl, tst = TD.prefill(tp, tc, torch.as_tensor(toks), MAX_LEN,
                         frame_embeds=tf)
    return jc, tc, jp, tp, tf, (jl, jst), (tl, tst)


@pytest.mark.parametrize("s_enc", [10, 16, 24],
                         ids=["below-max-len", "at-max-len", "trimmed"])
@pytest.mark.parametrize("frame_dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference_token_by_token(s_enc, frame_dtype):
    *_, (jl, jst), (tl, tst) = _prefilled(s_enc, frame_dtype)
    assert sorted(tst) == sorted(jst)
    assert tst["enc_len"] == int(jst["enc_len"]) == s_enc
    assert tst["cache_len"] == int(jst["cache_len"]) == PROMPT
    for name in ("cross_k", "cross_v", "k_cache", "v_cache"):
        assert tuple(tst[name].shape) == tuple(jst[name].shape), name
        assert tst[name].dtype == torch.float32, name
    n = min(s_enc, MAX_LEN)
    for name in ("cross_k", "cross_v"):
        assert not tst[name][:, :, n:].any()        # zero-padded
    if frame_dtype == "float32":
        for name in ("cross_k", "cross_v"):
            _close(tst[name], jst[name], 1e-4)
        _close(tl, jl, 1e-4)
        for name in ("k_cache", "v_cache"):
            _close(tst[name][:, :, :PROMPT], jst[name][:, :, :PROMPT], 1e-4)
    else:
        for name in ("cross_k", "cross_v"):
            _close(tst[name], jst[name], BF16_ATOL, BF16_RTOL)
        _close(tl, jl, BF16_ATOL, BF16_RTOL)


@pytest.mark.parametrize("frame_dtype,dtype", [("bfloat16", "float32"),
                                               ("float32", "bfloat16")])
def test_prefill_encodes_in_the_frames_dtype(frame_dtype, dtype):
    """Rule (a): the cached cross K/V are the port's ``encode`` run in the
    frames' dtype as given, cast to the state's dtype, bit for bit; a
    forward casts the frames to the compute dtype first."""
    _, tc = _cfgs(dtype)
    tp = bridge.params_from_numpy(_npp(), device="cpu")
    frames = torch.as_tensor(_frames(tc, 12, seed=9)).to(
        getattr(torch, frame_dtype))
    _, st = TD.prefill(tp, tc, torch.as_tensor(_tokens(tc, s=PROMPT)),
                       MAX_LEN, frame_embeds=frames)
    enc = TT.encode(tp, tc, frames)
    assert enc.dtype == frames.dtype
    for i, (k, v) in enumerate(TT.cross_kv(tp, tc, enc)):
        assert torch.equal(st["cross_k"][i, :, :12],
                           k.to(st["cross_k"].dtype))
        assert torch.equal(st["cross_v"][i, :, :12],
                           v.to(st["cross_v"].dtype))


@pytest.mark.parametrize("s_enc", [10, 24], ids=["below-max-len",
                                                 "trimmed"])
def test_decode_steps_match_reference(s_enc):
    jc, tc, jp, tp, _, (jl, jst), (tl, tst) = _prefilled(s_enc)
    for _ in range(3):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = tl.argmax(dim=-1)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jst = JD.decode_step(jp, jc, jtok, jst)
        tl, tst = TD.decode_step(tp, tc, ttok, tst)
        _close(tl, jl, 1e-4)
    assert np.array_equal(tl.argmax(dim=-1).numpy(),
                          np.asarray(jnp.argmax(jl, axis=-1)))
    for name in ("k_cache", "v_cache"):
        _close(tst[name][:, :, :PROMPT + 3], jst[name][:, :, :PROMPT + 3],
               1e-4)
    assert tst["cache_len"] == int(jst["cache_len"]) == PROMPT + 3
    assert tst["enc_len"] == s_enc


def test_generate_gives_reference_greedy_tokens():
    jc, tc = _cfgs()
    npp = _npp()
    jp = _jnp(npp)
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    prompts = tserve.make_prompts(tc, 2, PROMPT, seed=5, device="cpu")
    jf, tf = _as(_frames(jc, 20, seed=11), "float32")
    res = tserve.generate(lm, prompts, gen=4, frame_embeds=tf,
                          max_len=MAX_LEN)
    jl, jst = JD.prefill(jp, jc, jnp.asarray(prompts.numpy(), jnp.int32),
                         MAX_LEN, frame_embeds=jf)
    want = [np.asarray(jnp.argmax(jl, axis=-1))]
    for _ in range(3):
        jl, jst = JD.decode_step(jp, jc, jnp.asarray(want[-1], jnp.int32),
                                 jst)
        want.append(np.asarray(jnp.argmax(jl, axis=-1)))
    assert np.array_equal(res.tokens.numpy(), np.concatenate(want, axis=1))
    _close(res.last_logits, jl, 1e-4)


def test_generate_encodes_float32_frames_from_the_held_weights():
    """A bf16 config with float32 frames: ``generate`` encodes them in
    float32 from the held float32 weights, as the reference's prefill does
    from its params, so the cached cross K/V are the reference's cast to
    bf16 (one bf16 ulp: float32 sums in other orders may round across a
    bf16 boundary)."""
    jc, tc = _cfgs("bfloat16")
    npp = _npp()
    lm = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu"))
    prompts = tserve.make_prompts(tc, 2, PROMPT, seed=5, device="cpu")
    jf, tf = _as(_frames(jc, 20, seed=12), "float32")
    _, jst = JD.prefill(_jnp(npp), jc,
                        jnp.asarray(prompts.numpy(), jnp.int32), MAX_LEN,
                        frame_embeds=jf)
    with torch.inference_mode():
        _, st = TD.prefill(lm.compute_params(), tc, prompts, MAX_LEN,
                           frame_embeds=tf, encoder_params=lm.params)
    assert st["cross_k"].dtype == torch.bfloat16
    for name in ("cross_k", "cross_v"):
        _close(st[name], jst[name], BF16_ULP, 0)


def test_decode_matches_teacher_forced_forward_bf16():
    """In the port alone, bf16 weights and frames: the last decode logits
    against a forward over prompt + generated tokens on the same frames
    (``tests/test_serve.py``'s tolerance)."""
    _, tc = _cfgs("bfloat16")
    lm = TT.LM(tc, bridge.params_from_numpy(_npp(), device="cpu"))
    prompts = tserve.make_prompts(tc, 2, 12, seed=4, device="cpu")
    frames = torch.as_tensor(_frames(tc, 30, seed=13)).to(torch.bfloat16)
    res = tserve.generate(lm, prompts, gen=5, frame_embeds=frames,
                          max_len=32)
    full = lm(torch.cat([prompts, res.tokens[:, :-1]], dim=1), frames)
    _close(res.last_logits[:, 0], full[:, -1], BF16_ATOL, BF16_RTOL)
    assert res.tokens.shape == (2, 5)


# ---------------------------------------------------------------------------
# layout, the launcher
# ---------------------------------------------------------------------------

def test_port_init_has_reference_layout():
    _, tc = _cfgs()
    ref = _npp()
    port = bridge.params_to_numpy(TT.init_lm(tc, seed=0, device="cpu"))
    assert (jax.tree_util.tree_map(np.shape, port)
            == jax.tree_util.tree_map(np.shape, ref))
    assert (jax.tree_util.tree_map(lambda a: a.dtype, port)
            == jax.tree_util.tree_map(lambda a: a.dtype, ref))
    assert port["encoder_layers"]["attn"]["wq"].shape[0] == tc.encoder_layers
    assert port["cross_attn"]["attn"]["wk"].shape[0] == tc.num_layers
    assert (port["ln_enc"]["scale"] == 1).all()


def test_serve_main_runs_whisper_on_cpu(capsys):
    fa.launches = kr.launches = 3
    res = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    out = capsys.readouterr().out
    assert res.tokens.shape == (4, 32)
    assert "whisper-base on cpu" in out
    assert "flash-attention kernel launches: 0" in out
    assert "rwkv6 kernel launches: 0" in out
    assert bool(torch.isfinite(res.last_logits.float()).all())
