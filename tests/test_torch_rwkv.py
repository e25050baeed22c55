"""Port vs reference: the RWKV6 chunked recurrence and the RWKV6 block.

Seeded numpy inputs go to both packages.
* ``rwkv6_chunked_plain`` (the counterpart of the Pallas ``_rwkv_kernel``)
  against the reference's ``rwkv6_chunked_fwd`` (interpret mode on the CPU)
  on the same precomputed inputs, at the shapes of ``tests/test_kernels.py``
  plus chunk 64, both mask kinds: 1e-5 (the same float32 products in another
  summation order).
* ``rwkv6_fused_plain`` (the fused Hopper kernel's plain version) against
  ``rwkv6_mix(implementation="pallas")`` and the reference's chunked scan
  (with ``initial_state``), both masks, chunks 1 / 7 / 16 / 64, contiguous
  and ``split_heads`` views: float32 1e-5, bf16 one bf16 ulp of the output;
  the wrapper's refusals, its launch plan, and that the CPU never reaches
  the kernel's wrapper.
* ``ops.rwkv6_mix`` on CPU tensors against ``rwkv6_mix(implementation=
  "pallas")`` and the sequential ``rwkv6_ref``: 5e-4, the reference's own
  kernel tolerance (``tests/test_kernels.py:114``).
* ``chunked_linear_attention`` (output and final state, with and without
  ``initial_state``), ``linear_attention_step``,
  ``linear_attention_reference``, ``rwkv6_time_mix`` and
  ``rwkv6_channel_mix`` (each with and without decode state): float32 1e-5;
  bf16 0.15 / 0.05 where the reference rounds activations to bf16.
* Training: ``chunked_linear_attention_scan`` (the backward's recompute)
  against the reference's ``chunked_linear_attention``, output and final
  state 1e-5, grads 1e-4; the autograd Function around the kernel passes
  ``gradcheck`` in float64 (both outputs, every input) and its grads match
  ``jax.grad`` through the reference's chunk scan at 1e-4; the kernel's
  wrapper refuses inputs that require grad.
"""

import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.kernels.ops import rwkv6_mix as jax_rwkv6_mix  # noqa: E402
from repro.kernels.ref import rwkv6_ref  # noqa: E402
from repro.kernels.rwkv6 import rwkv6_chunked_fwd  # noqa: E402
from repro.models import ssm as js  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge, configs as tcfg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6 as kr  # noqa: E402
from repro_torch.models import ssm as ts  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

# (t, K, V, chunk): tests/test_kernels.py:97-99, plus chunk 64
SHAPES = [(64, 8, 8, 16), (128, 16, 32, 32), (96, 8, 8, 32), (128, 16, 16, 64)]
IDS = [f"t{t}-k{k}-v{v}-c{c}" for t, k, v, c in SHAPES]


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def _seq_inputs(seed, t, kdim, vdim, b=2, h=3, bonus=True):
    """q, k, v, log decay (as tests/test_kernels.py draws them) and a bonus,
    as numpy float32."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, h, t, kdim)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, h, t, vdim)).astype(np.float32)
    ld = np.log(rng.uniform(0.3, 1.0, (b, h, t, kdim))).astype(np.float32)
    u = ((rng.normal(size=(h, kdim)) * 0.2).astype(np.float32) if bonus
         else None)
    return q, k, v, ld, u


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("t,kdim,vdim,chunk", SHAPES, ids=IDS)
def test_plain_matches_pallas_kernel(t, kdim, vdim, chunk, exclusive):
    q, k, v, ld, _ = _seq_inputs(t + kdim, t, kdim, vdim)
    ins = kr.rwkv6_inputs(_t(q), _t(k), _t(v), _t(ld), chunk=chunk,
                           exclusive=exclusive)
    ref = rwkv6_chunked_fwd(*(jnp.asarray(x.numpy()) for x in ins),
                            chunk=chunk, exclusive=exclusive)
    out, S = kr.rwkv6_chunked_plain(*ins, chunk=chunk, exclusive=exclusive)
    assert out.dtype == S.dtype == torch.float32
    assert tuple(S.shape) == (6, kdim, vdim)
    _close(out, ref, 1e-5)
    # the final state the TPU kernel drops equals the jnp chunked scan's
    _, js_fin = js.chunked_linear_attention(
        _j(q), _j(k), _j(v), _j(ld), chunk=chunk,
        bonus=jnp.zeros((3, kdim)) if exclusive else None)
    _close(S.reshape(2, 3, kdim, vdim), js_fin, 1e-5)


@pytest.mark.parametrize("with_bonus", [False, True])
@pytest.mark.parametrize("t,kdim,vdim,chunk", SHAPES, ids=IDS)
def test_rwkv6_mix_matches_reference(t, kdim, vdim, chunk, with_bonus):
    q, k, v, ld, u = _seq_inputs(t + kdim, t, kdim, vdim, bonus=with_bonus)
    out = ops.rwkv6_mix(_t(q), _t(k), _t(v), _t(ld), bonus=_t(u), chunk=chunk)
    pallas = jax_rwkv6_mix(_j(q), _j(k), _j(v), _j(ld), bonus=_j(u),
                           chunk=chunk, implementation="pallas")
    seq, _ = rwkv6_ref(_j(q), _j(k), _j(v), _j(ld), bonus=_j(u))
    _close(out, pallas, 5e-4)
    _close(out, seq, 5e-4)


def test_rwkv6_mix_default_chunk_is_the_reference_one():
    q, k, v, ld, u = _seq_inputs(0, 128, 8, 8)
    out = ops.rwkv6_mix(_t(q), _t(k), _t(v), _t(ld), bonus=_t(u))
    ref = jax_rwkv6_mix(_j(q), _j(k), _j(v), _j(ld), bonus=_j(u),
                        implementation="pallas")
    _close(out, ref, 5e-4)
    with pytest.raises(ValueError, match="multiple"):
        ops.rwkv6_mix(_t(q)[:, :, :96], _t(k)[:, :, :96], _t(v)[:, :, :96],
                      _t(ld)[:, :, :96])


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("with_bonus", [False, True])
def test_chunked_linear_attention_matches_reference(with_bonus, with_state):
    q, k, v, ld, u = _seq_inputs(3, 64, 16, 32, bonus=with_bonus)
    s0 = (np.random.default_rng(4).normal(size=(2, 3, 16, 32))
          .astype(np.float32) if with_state else None)
    out, S = ts.chunked_linear_attention(_t(q), _t(k), _t(v), _t(ld),
                                         bonus=_t(u), chunk=16,
                                         initial_state=_t(s0))
    ref, ref_S = js.chunked_linear_attention(_j(q), _j(k), _j(v), _j(ld),
                                             bonus=_j(u), chunk=16,
                                             initial_state=_j(s0))
    assert S.dtype == torch.float32 and tuple(S.shape) == (2, 3, 16, 32)
    _close(out, ref, 1e-5)
    _close(S, ref_S, 1e-5)
    # and the sequential oracles agree with each other and with the chunks
    seq, seq_S = ts.linear_attention_reference(_t(q), _t(k), _t(v), _t(ld),
                                               bonus=_t(u),
                                               initial_state=_t(s0))
    jseq, jseq_S = js.linear_attention_reference(_j(q), _j(k), _j(v), _j(ld),
                                                 bonus=_j(u),
                                                 initial_state=_j(s0))
    _close(seq, jseq, 1e-5)
    _close(seq_S, jseq_S, 1e-5)
    _close(out, seq, 5e-4)
    _close(S, seq_S, 5e-4)


def test_chunked_linear_attention_bf16_inputs():
    """bf16 q/k/v/log decay: the output comes back in bf16, as the
    reference's; the state stays float32."""
    q, k, v, ld, u = _seq_inputs(5, 32, 16, 16)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, ld)]
    tb = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
          for x in bf]
    out, S = ts.chunked_linear_attention(*tb, bonus=_t(u), chunk=8)
    ref, ref_S = js.chunked_linear_attention(*bf, bonus=_j(u), chunk=8)
    assert out.dtype == torch.bfloat16 and S.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=0.15, rtol=0.05)
    _close(S, ref_S, 1e-5)


@pytest.mark.parametrize("with_bonus", [False, True])
def test_linear_attention_step_matches_reference(with_bonus):
    q, k, v, ld, u = _seq_inputs(6, 1, 16, 8, bonus=with_bonus)
    S = np.random.default_rng(7).normal(size=(2, 3, 16, 8)).astype(np.float32)
    o, S_new = ts.linear_attention_step(_t(q[:, :, 0]), _t(k[:, :, 0]),
                                        _t(v[:, :, 0]), _t(ld[:, :, 0]),
                                        _t(S), bonus=_t(u))
    jo, jS = js.linear_attention_step(_j(q[:, :, 0]), _j(k[:, :, 0]),
                                      _j(v[:, :, 0]), _j(ld[:, :, 0]), _j(S),
                                      bonus=_j(u))
    _close(o, jo, 1e-5)
    _close(S_new, jS, 1e-5)


# ---------------------------------------------------------------------------
# the RWKV6 block on the reference's own params
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layer0(dtype="float32"):
    """Layer 0 of reduced rwkv6-3b's reference params (numpy), its config,
    and the same params in the port's compute copy."""
    jc = jcfg.reduced(jcfg.get_config("rwkv6-3b"), dtype=dtype)
    tc = tcfg.reduced(tcfg.get_config("rwkv6-3b"), dtype=dtype)
    npp = jax.tree_util.tree_map(np.asarray,
                                 JT.init_lm(jc, jax.random.PRNGKey(0)))
    cp = TT.LM(tc, bridge.params_from_numpy(npp, device="cpu")) \
        .compute_params()
    lay = jax.tree_util.tree_map(lambda a: a[0], npp["layers"])
    return jc, lay, TT.layer(cp["layers"], 0)


def _x(dtype, b=2, t=12, d=64, seed=8):
    x = np.random.default_rng(seed).normal(size=(b, t, d)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(np.array(jx, np.float32))
    return jx, tx.to(torch.bfloat16) if dtype == "bfloat16" else tx


DTOL = {"float32": (1e-5, 1e-5), "bfloat16": (0.15, 0.05)}


@pytest.mark.parametrize("decode", [False, True], ids=["sequence", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_matches_reference(dtype, decode):
    jc, lay, tl = _layer0(dtype)
    hd = jc.rwkv_head_dim
    jx, tx = _x(dtype, t=1 if decode else 12)
    jst = tst = None
    if decode:
        rng = np.random.default_rng(9)
        S = rng.normal(size=(2, 4, hd, hd)).astype(np.float32)
        last, _ = _x(dtype, t=1, seed=10)
        jst = {"S": jnp.asarray(S), "last": last[:, 0]}
        tst = {"S": torch.from_numpy(S),
               "last": torch.from_numpy(np.array(last[:, 0], np.float32))
               .to(tx.dtype)}
    y, st = ts.rwkv6_time_mix(tl["tmix"], tx, hd, chunk=4, state=tst)
    jy, jst_out = js.rwkv6_time_mix(lay["tmix"], jx, hd, chunk=4, state=jst)
    atol, rtol = DTOL[dtype]
    assert y.dtype == tx.dtype
    np.testing.assert_allclose(_np(y), _np(jy), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(st["S"]), _np(jst_out["S"]),
                               atol=atol, rtol=rtol)
    _close(st["last"], jst_out["last"], 1e-5)


@pytest.mark.parametrize("decode", [False, True], ids=["sequence", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(dtype, decode):
    _, lay, tl = _layer0(dtype)
    jx, tx = _x(dtype, t=1 if decode else 12)
    jlast, tlast = _x(dtype, t=1, seed=11)
    y, last = ts.rwkv6_channel_mix(tl["cmix"], tx,
                                   state=tlast[:, 0] if decode else None)
    jy, jl = js.rwkv6_channel_mix(lay["cmix"], jx,
                                  state=jlast[:, 0] if decode else None)
    atol, rtol = DTOL[dtype]
    np.testing.assert_allclose(_np(y), _np(jy), atol=atol, rtol=rtol)
    _close(last, jl, 1e-5)


def test_w_o_scales_by_row_sums_not_a_matmul():
    """``ssm.py:281`` projects with einsum("btd,de->btd"): each channel times
    the row sum of w_o.  With a non-symmetric w_o the port matches the
    reference and a plain ``y @ w_o`` would not."""
    jc, lay, tl = _layer0()
    hd = jc.rwkv_head_dim
    d = jc.d_model
    w_o = np.random.default_rng(12).normal(size=(d, d)).astype(np.float32)
    w_o += np.triu(np.ones((d, d), np.float32))        # non-symmetric
    assert not np.allclose(w_o, w_o.T)
    jx, tx = _x("float32")
    jt = {**lay["tmix"], "w_o": w_o}
    tt = {**tl["tmix"], "w_o": torch.from_numpy(w_o)}
    y, _ = ts.rwkv6_time_mix(tt, tx, hd, chunk=4)
    jy, _ = js.rwkv6_time_mix(jt, jx, hd, chunk=4)
    _close(y, jy, 1e-4)
    # the output before the projection: an identity w_o has unit row sums
    pre, _ = ts.rwkv6_time_mix({**tt, "w_o": torch.eye(d)}, tx, hd, chunk=4)
    _close(pre * torch.from_numpy(w_o.sum(axis=1)), jy, 1e-4)
    assert not np.allclose(_np(pre @ torch.from_numpy(w_o)), _np(jy),
                           atol=1e-2)


def test_compute_copy_keeps_float32_leaves():
    """The bf16 compute copy keeps ``decay_base`` and ``bonus_u`` in float32,
    as the reference reads them (``ssm.py:264``, ``:100-101``); ``mix_x``
    and ``cmix/mix`` are cast to bf16 by the reference too.  Rounding the
    decay base to bf16 would change the log decay the reference computes."""
    tc = tcfg.reduced(tcfg.get_config("rwkv6-3b"))
    params = TT.init_lm(tc, seed=1, device="cpu")
    base = params["layers"]["tmix"]["decay_base"]
    base += torch.linspace(0.0, 1e-2, base.shape[-1])   # not bf16 values
    assert not torch.equal(base.to(torch.bfloat16).float(), base)
    cp = TT.LM(tc, params).compute_params()
    tmix = cp["layers"]["tmix"]
    for name in ("decay_base", "bonus_u"):
        assert tmix[name].dtype == torch.float32, name
        assert torch.equal(tmix[name], params["layers"]["tmix"][name]), name
    for w in (tmix["mix_x"], tmix["w_r"], tmix["w_o"],
              cp["layers"]["cmix"]["mix"], cp["layers"]["cmix"]["w_k"]):
        assert w.dtype == torch.bfloat16
    assert tmix["ln_x"]["scale"].dtype == torch.float32


def test_time_mix_bf16_reads_decay_base_in_float32():
    """On bf16 activations the port's time-mix equals the reference's on the
    same params, whose decay base is not a bf16 value."""
    jc, lay, tl = _layer0("bfloat16")
    hd = jc.rwkv_head_dim
    base = lay["tmix"]["decay_base"] + np.linspace(0, 1e-2, jc.d_model,
                                                   dtype=np.float32)
    jt = {**lay["tmix"], "decay_base": base}
    tt = {**tl["tmix"], "decay_base": torch.from_numpy(base)}
    jx, tx = _x("bfloat16")
    y, st = ts.rwkv6_time_mix(tt, tx, hd, chunk=4)
    jy, jst = js.rwkv6_time_mix(jt, jx, hd, chunk=4)
    np.testing.assert_allclose(_np(y), _np(jy), atol=0.15, rtol=0.05)
    _close(st["S"], jst["S"], 2e-2)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper takes CUDA tensors only; the CPU goes to the plain
    version through ``ops``."""
    q, k, v, ld, u = _seq_inputs(0, 16, 8, 8)
    before = kr.launches
    with pytest.raises(ValueError, match="CUDA"):
        kr.rwkv6_fused(_t(q), _t(k), _t(v), _t(ld), bonus=_t(u), chunk=16)
    assert kr.launches == before


def _refusal_cases():
    """(name, arguments of rwkv6_fused, message): each refused before the
    device is looked at, so the CPU can check them."""
    q, k, v, ld, u = (_t(x) for x in _seq_inputs(1, 32, 16, 16, b=1, h=2))
    wide = torch.zeros(1, 2, 32, 257)
    return [
        ("mixed-dtypes", (q, k.double(), v, ld), {}, "one dtype"),
        ("float64", (q.double(), k.double(), v.double(), ld.double()), {},
         "bf16 or float32"),
        ("mixed-bf16", (q.to(torch.bfloat16), k, v, ld), {}, "one dtype"),
        ("inner-stride", (q.transpose(2, 3).contiguous().transpose(2, 3), k,
                          v, ld), {}, "inner stride"),
        ("k257", (wide, wide, v, wide), {}, "K=257"),
        ("v257", (q, k, torch.zeros(1, 2, 32, 257), ld), {}, "V=257"),
        ("shape", (q, k[:, :, :16], v, ld), {}, "shape"),
        ("chunk-128", (q, k, v, ld), {"chunk": 128}, "chunk"),
        ("chunk-not-dividing", (q, k, v, ld), {"chunk": 5}, "chunk"),
        ("bonus-shape", (q, k, v, ld), {"bonus": u[:1]}, "bonus"),
        ("state-shape", (q, k, v, ld),
         {"initial_state": torch.zeros(2, 16, 8)}, "initial_state"),
        ("vb-12", (q, k, v, ld), {"vb": 12}, "vb"),
        ("vb-128", (q, k, v, ld), {"vb": 128}, "vb"),
        ("vb-wider-than-v", (q, k, torch.zeros(1, 2, 32, 8), ld),
         {"vb": 16}, "vb"),
        ("cpu", (q, k, v, ld), {"bonus": u}, "CUDA"),
    ]


@pytest.mark.parametrize("case", range(len(_refusal_cases())), ids=[
    c[0] for c in _refusal_cases()])
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(case):
    name, args, kw, msg = _refusal_cases()[case]
    kw = {"chunk": 16, **kw}
    before = kr.launches
    with pytest.raises(ValueError, match=msg):
        kr.rwkv6_fused(*args, **kw)
    assert kr.launches == before


@pytest.mark.parametrize("dk,dv,t,chunk", [(24, 16, 32, 16),
                                            (16, 24, 32, 16),
                                            (16, 16, 256, 128)],
                         ids=["k24", "v24", "chunk-128"])
def test_fused_wrapper_takes_what_it_once_refused(dk, dv, t, chunk):
    """K and V off powers of two and chunks above 64 (RunConfig's 128),
    which the kernel once refused: every check passes, and the wrapper
    stops only at the CPU tensor."""
    q, k, v, ld, _ = (_t(x) for x in _seq_inputs(1, t, dk, dv, b=1, h=2))
    before = kr.launches
    with pytest.raises(ValueError, match="CUDA"):
        kr.rwkv6_fused(q, k, v, ld, chunk=chunk)
    assert kr.launches == before
    assert kr.plan(dk, dv, chunk, 4)["chunk"] == chunk


def test_cpu_dispatch_never_calls_the_kernel_wrapper(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")
    monkeypatch.setattr(ops, "rwkv6_fused", refuse)
    monkeypatch.setattr(kr, "rwkv6_fused", refuse)
    q, k, v, ld, u = (_t(x) for x in _seq_inputs(2, 32, 16, 16))
    before = kr.launches
    out, S = ops.rwkv6_mix_state(q, k, v, ld, bonus=u, chunk=16)
    ref, ref_S = kr.rwkv6_fused_plain(q, k, v, ld, bonus=u, chunk=16)
    assert torch.equal(out, ref) and torch.equal(S, ref_S)
    assert kr.launches == before


# ---------------------------------------------------------------------------
# the fused function's plain version against the reference
# ---------------------------------------------------------------------------

FUSED_T = {1: 8, 7: 21, 16: 48, 64: 128}     # T for each chunk


def _bf16_ulp(x):
    mag = np.maximum(np.abs(np.asarray(x, np.float32)), 1e-30)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _fused_inputs(seed, t, dtype, layout, decay, b=2, h=3, kdim=16, vdim=8):
    """numpy float32 q, k, v, log decay (bf16 values for bf16) and the
    port's tensors in ``dtype``, either contiguous (B, H, T, D) or as the
    model's ``split_heads`` views of contiguous (B, T, H·D) tensors.  The
    log decay is tests/test_kernels.py's ("mild": log U(0.3, 1)) or the
    model's kind ("model": -exp(N(-0.5, 1)), the clamp at -4 active)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, t, d)).astype(np.float32)
            for d in (kdim, kdim, vdim)]
    if decay == "model":
        ld = -np.exp(rng.normal(size=(b, h, t, kdim)) - 0.5)
    else:
        ld = np.log(rng.uniform(0.3, 1.0, (b, h, t, kdim)))
    arrs.append(ld.astype(np.float32))
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ts_ = []
    for a in arrs:
        if layout == "split_heads":
            d = a.shape[-1]
            flat = torch.from_numpy(np.ascontiguousarray(
                a.transpose(0, 2, 1, 3).reshape(b, t, h * d))).to(tdt)
            x = flat.reshape(b, t, h, d).transpose(1, 2)
            assert not x.is_contiguous()
        else:
            x = torch.from_numpy(a).to(tdt)
        ts_.append(x)
    return arrs, ts_


@pytest.mark.parametrize("layout", ["contiguous", "split_heads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("with_bonus", [False, True],
                         ids=["inclusive", "bonus"])
@pytest.mark.parametrize("chunk,decay", [
    (1, "mild"), (7, "mild"), (16, "mild"), (64, "mild"),
    (1, "model"), (7, "model"), (16, "model")])
def test_fused_plain_matches_reference(chunk, decay, with_bonus, with_state,
                                       dtype, layout):
    """``rwkv6_fused_plain`` against the reference: without a state,
    ``rwkv6_mix(implementation="pallas")`` (interpret mode) on the same
    dtype; with one, the reference's chunked scan with ``initial_state`` in
    float32 on the same values.  float32 1e-5 (1e-4 at chunk 64, see
    below); bf16 one bf16 ulp of the output (both round float32 sums
    once).  Final S against the reference's
    chunked scan at 1e-5.  The model's decay runs at the chunks the model
    path takes (``_fit_chunk`` gives at most 16)."""
    t = FUSED_T[chunk]
    arrs, (q, k, v, ld) = _fused_inputs(chunk + 10 * with_bonus, t, dtype,
                                        layout, decay)
    rng = np.random.default_rng(chunk)
    u = (rng.normal(size=(3, 16)) * 0.2).astype(np.float32) \
        if with_bonus else None
    s0 = rng.normal(size=(2, 3, 16, 8)).astype(np.float32) \
        if with_state else None
    out, S = kr.rwkv6_fused_plain(q, k, v, ld, bonus=_t(u), chunk=chunk,
                                  initial_state=_t(s0))
    assert out.dtype == q.dtype and tuple(out.shape) == (2, 3, t, 8)
    assert S.dtype == torch.float32 and tuple(S.shape) == (2, 3, 16, 8)
    jf = [jnp.asarray(a) for a in arrs]
    scan, scan_S = js.chunked_linear_attention(*jf, bonus=_j(u), chunk=chunk,
                                               initial_state=_j(s0))
    _close(S, scan_S, 1e-5)
    if with_state:
        ref = np.asarray(scan, np.float32)
    else:
        jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        ref = np.asarray(jax_rwkv6_mix(*(a.astype(jd) for a in jf),
                                       bonus=_j(u), chunk=chunk,
                                       implementation="pallas"), np.float32)
    got = _np(out)
    if dtype == "float32":
        # at chunk 64 the in-chunk cumsum reaches -77: JAX's CPU cumsum is a
        # tree scan whose L differs from a sequential one by up to 7.6e-6,
        # which e^L turns into up to 2.1e-5 at the output; the same tiles
        # agree at 1e-5 (test_plain_matches_pallas_kernel)
        tol = 1e-4 if chunk == 64 else 1e-5
        np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)
    else:
        ulp = np.maximum(_bf16_ulp(ref), _bf16_ulp(got))
        assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("t,chunk", [(12, 8), (12, 5), (256, 96), (12, 0),
                                     (65, 10)])
def test_check_chunk_refuses(t, chunk):
    with pytest.raises(ValueError, match="chunk"):
        kr.check_chunk(t, chunk)


@pytest.mark.parametrize("t,chunk", [(256, 128), (65, 65), (2048, 2048),
                                     (300, 100)])
def test_check_chunk_takes_every_divisor(t, chunk):
    """Every chunk that divides T, as the Pallas kernel takes it: above 64
    rows the kernel runs the chunk in sub-blocks."""
    kr.check_chunk(t, chunk)


def test_check_chunk_takes_every_chunk_the_model_path_fits():
    """The kernel takes whatever ``_fit_chunk`` gives a prompt, powers of
    two or not (12 tokens: chunk 12; 7 tokens: chunk 7)."""
    for t in range(1, 2100):
        chunk = TT._fit_chunk(t, 16)
        assert chunk == JT._fit_chunk(t, 16)
        kr.check_chunk(t, chunk)
    assert TT._fit_chunk(12, 16) == 12 and TT._fit_chunk(7, 16) == 7


def test_fit_chunk_matches_reference():
    for t in (1, 7, 12, 16, 96, 2048, 2080):
        assert TT._fit_chunk(t, 16) == JT._fit_chunk(t, 16), t


@pytest.mark.parametrize("t", [2048, 1024, 96, 12])
def test_launched_chunk_of_run_configs_chunk(t, monkeypatch):
    """``RunConfig``'s chunk 128 (``make_context``'s) through the model
    path's ``_fit_chunk`` is the chunk the recurrence's op is handed, the
    one its forward runs and its backward recomputes at: the kernel takes
    every chunk that divides T (its plan runs a chunk above 64 in
    sub-blocks), so nothing shrinks it on the card.  At T 2048: 128."""
    from repro_torch.configs import RunConfig
    asked = TT._fit_chunk(t, RunConfig().ssm_chunk)
    assert asked == JT._fit_chunk(t, 128)
    seen, op = [], ops.rwkv6_fused_op

    def probe(q, k, v, ld, bonus, s0, chunk):
        seen.append(chunk)
        return op(q, k, v, ld, bonus, s0, chunk)

    monkeypatch.setattr(ops, "rwkv6_fused_op", probe)
    q, k, v, ld, u = (_t(x) for x in _seq_inputs(t, t, 8, 8, b=1, h=2))
    q.requires_grad_()
    out, _ = ops.rwkv6_mix_state(q, k, v, ld, bonus=u, chunk=asked)
    out.sum().backward()
    assert seen == [asked]
    kr.check_chunk(t, asked)
    plan = kr.plan(8, 8, asked, 2)
    assert plan["chunk"] == asked and plan["cs"] == min(asked, kr.MAX_SUB)
    if t == 2048:
        assert asked == 128


@pytest.mark.parametrize("with_bonus", [False, True],
                         ids=["inclusive", "bonus"])
def test_plain_chunk_128_equals_chunk_16(with_bonus):
    """The recurrence carries its state exactly across chunk boundaries, so
    the chunk changes only the rounding: the plain version at chunk 128
    (what a caller of ``RunConfig()`` asks for) equals chunk 16 within
    1e-5, output and final state, with a carried initial state.  On
    float64 values (the plain version then computes in float64), so that
    the test sees the function: in float32 the two chunks' outputs, of
    magnitude up to ~20 here, differ by up to 1.4e-4, since e^L over a
    128-step cumsum spans more of float32's range than over 16."""
    _, ins = _fused_inputs(11 + with_bonus, 256, "float32", "contiguous",
                           "model")
    ins = [x.double() for x in ins]
    rng = np.random.default_rng(12)
    u = torch.from_numpy(rng.normal(size=(3, 16)) * 0.2) \
        if with_bonus else None
    s0 = torch.from_numpy(rng.normal(size=(2, 3, 16, 8)))
    a = kr.rwkv6_fused_plain(*ins, bonus=u, chunk=128, initial_state=s0)
    b = kr.rwkv6_fused_plain(*ins, bonus=u, chunk=16, initial_state=s0)
    for x, y in zip(a, b):
        assert x.dtype == torch.float64
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# training: the chunk scan and the autograd Function around the kernel
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """One intra-op thread for the small-tensor training tests: the suite
    runs six workers on eight cores, and torch's default thread pool per
    worker oversubscribes the cores; its spinning threads made a 60-step
    test take 210 s there against 5 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_case(with_bonus, with_state, t=48, kdim=8, vdim=16):
    q, k, v, ld, u = _seq_inputs(11, t, kdim, vdim, bonus=with_bonus)
    s0 = (np.random.default_rng(12).normal(size=(2, 3, kdim, vdim))
          .astype(np.float32) if with_state else None)
    return q, k, v, ld, u, s0


def _loss_weights(out_shape, s_shape):
    rng = np.random.default_rng(13)
    return (rng.normal(size=out_shape).astype(np.float32),
            rng.normal(size=s_shape).astype(np.float32))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("with_bonus", [False, True],
                         ids=["inclusive", "bonus"])
def test_scan_matches_reference_chunked_linear_attention(with_bonus,
                                                         with_state, chunk):
    q, k, v, ld, u, s0 = _scan_case(with_bonus, with_state)
    args = [q, k, v, ld, u, s0]
    ref, ref_S = js.chunked_linear_attention(
        *map(_j, args[:4]), bonus=_j(u), chunk=chunk, initial_state=_j(s0))
    ins = [None if x is None else _t(x).clone().requires_grad_()
           for x in args]
    out, S = ts.chunked_linear_attention_scan(
        *ins[:4], bonus=ins[4], chunk=chunk, initial_state=ins[5])
    assert out.dtype == S.dtype == torch.float32
    _close(out.detach(), ref, 1e-5)
    _close(S.detach(), ref_S, 1e-5)
    wo, ws = _loss_weights(out.shape, S.shape)
    names = [i for i, x in enumerate(args) if x is not None]

    def jloss(*xs):
        full = list(args)
        for i, x in zip(names, xs):
            full[i] = x
        o, st = js.chunked_linear_attention(
            *full[:4], bonus=full[4], chunk=chunk, initial_state=full[5])
        return (o * wo).sum() + (st * ws).sum()
    jg = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(_j(args[i]) for i in names))
    ((out * _t(wo)).sum() + (S * _t(ws)).sum()).backward()
    for i, g in zip(names, jg):
        _close(ins[i].grad, g, 1e-4)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("with_bonus", [False, True],
                         ids=["inclusive", "bonus"])
def test_rwkv6_function_gradcheck(with_bonus, with_state):
    """float64 on the CPU: the forward is the fused kernel's plain version,
    the backward autograd through the chunk scan; both outputs carry a
    gradient, to every input."""
    rng = np.random.default_rng(14)
    b, h, t, kd, vd = 1, 2, 8, 3, 2
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, d)))
               for d in (kd, kd, vd))
    ld = torch.from_numpy(np.log(rng.uniform(0.3, 1.0, (b, h, t, kd))))
    u = torch.from_numpy(rng.normal(size=(h, kd)) * 0.2) if with_bonus \
        else None
    s0 = torch.from_numpy(rng.normal(size=(b, h, kd, vd))) if with_state \
        else None
    ins = [x.requires_grad_() for x in (q, k, v, ld, u, s0) if x is not None]

    def f(*xs):
        it = iter(xs)
        full = [next(it) if x is not None else None
                for x in (q, k, v, ld, u, s0)]
        return ops.rwkv6_mix_state(*full[:4], bonus=full[4], chunk=4,
                                   initial_state=full[5])
    out, S = f(*ins)
    assert out.dtype == S.dtype == torch.float64
    assert torch.autograd.gradcheck(f, ins)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("with_bonus", [False, True],
                         ids=["inclusive", "bonus"])
def test_rwkv6_function_grads_match_reference(with_bonus, with_state):
    """The port's Function (forward ``rwkv6_fused_plain``, backward through
    the scan) against ``jax.grad`` through the reference's chunk scan, at
    the recurrence's 1e-4."""
    q, k, v, ld, u, s0 = _scan_case(with_bonus, with_state, t=64, kdim=16,
                                    vdim=16)
    args = [q, k, v, ld, u, s0]
    names = [i for i, x in enumerate(args) if x is not None]
    wo, ws = _loss_weights((2, 3, 64, 16), (2, 3, 16, 16))

    def jloss(*xs):
        full = list(args)
        for i, x in zip(names, xs):
            full[i] = x
        o, st = js.chunked_linear_attention(
            *full[:4], bonus=full[4], chunk=16, initial_state=full[5])
        return (o * wo).sum() + (st * ws).sum()
    jg = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(_j(args[i]) for i in names))
    ins = [None if x is None else _t(x).clone().requires_grad_()
           for x in args]
    out, S = ops.rwkv6_mix_state(*ins[:4], bonus=ins[4], chunk=16,
                                 initial_state=ins[5])
    assert out.grad_fn is not None and S.grad_fn is not None
    ((out * _t(wo)).sum() + (S * _t(ws)).sum()).backward()
    for i, g in zip(names, jg):
        _close(ins[i].grad, g, 1e-4)


def test_kernel_wrapper_refuses_inputs_that_require_grad():
    q, k, v, ld, u = (_t(x) for x in _seq_inputs(0, 16, 8, 8))
    before = kr.launches
    with pytest.raises(RuntimeError, match="requires grad"):
        kr.rwkv6_fused(q, k, v, ld, bonus=u.clone().requires_grad_(),
                       chunk=16)
    with pytest.raises(RuntimeError, match="kernels.ops"):
        kr.rwkv6_fused(q.clone().requires_grad_(), k, v, ld, chunk=16)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        kr.rwkv6_fused(q.clone().requires_grad_(), k, v, ld, chunk=16)
    assert kr.launches == before
