"""The compile-only dry run (``repro_torch.launch.dryrun``,
``repro_torch.launch.hlo_analysis``) against the reference's.

The reference compiles each cell with XLA and reads the module; the port
runs the step once on fake tensors and a fake process group under a
recording dispatch mode.  Held here, on the CPU, all in this process (the
fake group is made and destroyed by each cell; none is left behind):

* the collective byte accounting equals the reference's
  ``parse_collectives`` on the same (op, result shape, group size), for all
  five kinds;
* the recorder counts the work of one rank: a DTensor product on a fake
  4 x 4 mesh counts rank 0's local product, not the global one;
* the kernels' registered ops pass ``torch.library.opcheck`` and their FLOP
  formulas (attention's live pairs, the recurrence's chunk) are what the
  recorder counts;
* per device: a reduced tinyllama train cell on a fake (2, 2) mesh counts
  FLOPs whose 4x equals the same step's count with no mesh, and the
  collectives by op of a real 4-rank gloo run of the same step;
* the twin of ``tests/test_distributed.py::test_small_mesh_dryrun_cell``
  and ``lower_cell`` at reduced size for every mode and family, the int8
  state, the 16 x 16 production mesh, ``cell_supported``'s skip;
* ``extrapolate_roofline`` agrees with the direct count within 1e-6;
* the scaled count (two depths, up to three microbatch counts, scaled to
  the full depth) equals the full count in FLOPs, bytes accessed, ops,
  kernel op calls, collectives by op and argument and state bytes, for the
  dense, moe, hybrid and audio families at 1, 2 and 3 microbatches and for
  decode; its peak memory ``temp`` is scaled too and lands 2.8-9.9% under
  the full count's at these sizes (the peak does not grow linearly with
  depth), held within 15%.  The full count runs after the scaled one in
  the same process, both warm: a process's first backward records a few
  hundred one-off ops (319 on reduced zamba2), which the scaled count
  leaves out by a discarded warm-up variant.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import hlo_analysis as TH  # noqa: E402

SMALL = dict(num_layers=2, num_heads=4, num_kv_heads=2, d_model=64,
             head_dim=16, vocab_size=256, d_ff=128)


def _tiny(**over):
    return tcfg.reduced(tcfg.get_config("tinyllama-1.1b"),
                        **{**SMALL, **over})


def _no_group():
    import torch.distributed as dist
    return not dist.is_initialized()


# ---------------------------------------------------------------------------
# the accounting
# ---------------------------------------------------------------------------

_HLO_OP = {"all-gather": "all-gather", "all-reduce": "all-reduce",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}


@pytest.mark.parametrize("group", [1, 2, 4, 16])
@pytest.mark.parametrize("dtype,nbytes", [("f32", 4), ("bf16", 2),
                                          ("s8", 1)])
@pytest.mark.parametrize("kind", list(TH.COLLECTIVES))
def test_byte_accounting_matches_reference(kind, dtype, nbytes, group):
    """The same (op, result shape, group size) through the reference's HLO
    parser and the port's record parser give the same stats."""
    dims = (8, 96)
    members = ",".join(str(i) for i in range(group))
    line = (f"  %c = {dtype}[{','.join(map(str, dims))}]{{1,0}} "
            f"{_HLO_OP[kind]}(%p), replica_groups={{{{{members}}}}}")
    want = JH.parse_collectives(line).to_json()
    got = TH.parse_collectives(
        [(kind, int(np.prod(dims)) * nbytes, group)]).to_json()
    assert got == want


def test_roofline_keys_and_constants():
    r = TH.Roofline(hlo_flops=989e12, hbm_bytes=3.35e12, wire_bytes=50e9,
                    chips=4, model_flops=2 * 989e12)
    ref = JH.Roofline(hlo_flops=1.0, hbm_bytes=1.0, wire_bytes=1.0, chips=4)
    assert set(r.to_json()) == set(ref.to_json())
    assert r.t_compute == r.t_memory == r.t_collective == 1.0
    assert r.useful_flops_ratio == 0.5
    assert set(TH.memory_summary(TH.Recorder(), 0)) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes"}


def test_recorder_counts_one_ranks_work():
    """A [Shard(0), Replicate] x [Replicate, Shard(1)] product on a fake
    4 x 4 mesh: the recorder counts rank 0's (64, 128) x (128, 256), and
    its grads' products at their local shapes; the forward all-gathers
    nothing."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard
    with TD.FakeWorld(16):
        mesh = DeviceMesh("cpu", torch.arange(16).reshape(4, 4))
        with FakeTensorMode(allow_non_fake_inputs=True):
            a = TD.fake_dtensor((256, 128), torch.float32, "cpu", mesh,
                                [Shard(0), Replicate()])
            b = TD.fake_dtensor((128, 1024), torch.float32, "cpu", mesh,
                                [Replicate(), Shard(1)])
            rec = TH.Recorder(device_type="cpu")
            with rec:
                c = a @ b
            assert rec.flops == 2 * 64 * 128 * 256
            assert rec.collectives == []
            assert rec.bytes == 4 * (64 * 128 + 128 * 256 + 64 * 256)
            assert rec.peak_bytes == 4 * 64 * 256
            assert c.to_local().shape == (64, 256)
    assert not dist.is_initialized()


def test_fake_world_keeps_a_group_it_did_not_make():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    r = TD.lower_cell("tinyllama-1.1b", "t", False,
                      {"remat": "none", "skip_aux": True}, cfg=_tiny(),
                      shape_cfg=tcfg.ShapeConfig("t", 16, 4, "decode"),
                      mesh_shape=(2, 2), device="cpu")
    assert r["status"] == "ok" and dist.is_initialized()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the kernels' registered ops
# ---------------------------------------------------------------------------

def _attn_args(seed, sq=33, skv=33, hq=4, hkv=2, hd=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, sq, hq, hd, generator=g),
            torch.randn(2, skv, hkv, hd, generator=g),
            torch.randn(2, skv, hkv, hd, generator=g))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 7)])
def test_attention_op_passes_opcheck(causal, window):
    from repro_torch.kernels import ops
    torch.library.opcheck(ops.flash_attention_op,
                          (*_attn_args(0), causal, window))


def _rwkv_args(seed, bonus, state, t=32, k=16, v=8):
    g = torch.Generator().manual_seed(seed)
    q, kk = (torch.randn(1, 2, t, k, generator=g) for _ in range(2))
    vv = torch.randn(1, 2, t, v, generator=g)
    ld = -torch.rand(1, 2, t, k, generator=g)
    return (q, kk, vv, ld,
            torch.randn(2, k, generator=g) if bonus else None,
            torch.randn(1, 2, k, v, generator=g) if state else None)


@pytest.mark.parametrize("bonus,state,chunk", [(True, True, 16),
                                               (False, False, 8),
                                               (True, False, 32)])
def test_recurrence_op_passes_opcheck(bonus, state, chunk):
    from repro_torch.kernels import ops
    torch.library.opcheck(ops.rwkv6_fused_op,
                          (*_rwkv_args(1, bonus, state), chunk))


@pytest.mark.parametrize("sq,skv,causal,window", [
    (33, 33, True, None), (33, 33, True, 5), (5, 9, False, 3),
    (300, 1500, False, None), (1, 1500, False, None), (129, 63, True, 48),
    (64, 64, False, None)])
def test_live_pairs_counts_the_mask(sq, skv, causal, window):
    from repro_torch.kernels import flash_attention as fa
    want = 0
    for q in range(sq):
        hi = min(skv, q + 1) if causal else skv
        lo = max(0, q - window + 1) if window else 0
        want += max(0, hi - lo)
    assert fa.live_pairs(sq, skv, causal, window) == want


def test_recorder_reads_the_kernels_flop_formulas():
    """One call of each entry point on the CPU: the recorder counts the
    registered op once, at its formula (4·B·Hq·hd·pairs; per (B, H)
    T·(2c·(K + V) + 4·K·V))."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6 as kr
    q, k, v = _attn_args(2)
    rec = TH.Recorder()
    with rec, torch.no_grad():
        ops.attention(q, k, v, causal=True, window=5)
    assert rec.op_calls == {"flash_attention_fwd": 1}
    assert rec.flops == fa.flops(2, 33, 33, 4, 16, True, 5) == \
        4 * 2 * 4 * 16 * fa.live_pairs(33, 33, True, 5)
    args = _rwkv_args(3, True, False)
    rec = TH.Recorder()
    with rec, torch.no_grad():
        ops.rwkv6_mix_state(*args[:4], bonus=args[4], chunk=16)
    assert rec.op_calls == {"rwkv6_fused_fwd": 1}
    assert rec.flops == kr.flops(1, 2, 32, 16, 8, 16) == \
        2 * 32 * (2 * 16 * (16 + 8) + 4 * 16 * 8)


# ---------------------------------------------------------------------------
# per device
# ---------------------------------------------------------------------------

PER_DEVICE_SHAPE = tcfg.ShapeConfig("t", 32, 4, "train")
PER_DEVICE_RUN = tcfg.RunConfig(remat="none", sequence_parallel=False)


def _fake_counts(mesh_shape):
    """A reduced tinyllama train step counted on a fake mesh (None: one
    device): (flops, kernel op calls, collectives by op, wire bytes)."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.context import NULL_CTX
    from repro_torch.parallel.sharding import make_context
    cfg = _tiny()
    if mesh_shape is None:
        run = TD.count_step(cfg, PER_DEVICE_SHAPE, NULL_CTX,
                            param_dtype=torch.float32, device="cpu")
    else:
        with TD.FakeWorld(4):
            ctx = make_context(make_smoke_mesh(mesh_shape, device="cpu"),
                               cfg, PER_DEVICE_RUN)
            run = TD.count_step(cfg, PER_DEVICE_SHAPE, ctx,
                                param_dtype=torch.float32, device="cpu")
    rec = run["recorder"]
    stats = rec.stats()
    return (rec.flops, dict(rec.op_calls), dict(stats.count),
            stats.total_wire_bytes)


def _rank_counts(rank, world, payload):
    """The same step on real gloo ranks, real tensors, under the recorder."""
    import logging

    from repro_torch import bridge
    from repro_torch.launch.dryrun import sharded_param_specs
    from repro_torch.launch.hlo_analysis import Recorder
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.parallel.sharding import abstract_params, make_context
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    cfg = _tiny()
    ctx = make_context(make_smoke_mesh(payload["mesh"], device="cpu"), cfg,
                       PER_DEVICE_RUN)
    params = bridge.place_params(init_lm(cfg, 0, device="cpu"), cfg,
                                 ctx.mesh)
    opt_cfg = OptimizerConfig()
    step = make_train_step(cfg, opt_cfg, ctx=ctx, grad_shardings=(
        sharded_param_specs(abstract_params(cfg), cfg, ctx.mesh)))
    state = adamw_init(params, opt_cfg)
    rec = Recorder(device_type="cpu")
    with rec:
        step(params, state, None, payload["batch"])
    stats = rec.stats()
    return (rec.flops, dict(rec.op_calls), dict(stats.count),
            stats.total_wire_bytes)


@pytest.fixture(scope="module")
def real_counts(tmp_path_factory):
    from repro_torch.testing import run_ranks
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (4, 33)).astype(np.int32)
    payload = {"mesh": (2, 2),
               "batch": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}
    return run_ranks(_rank_counts, 4, (payload,),
                     workdir=tmp_path_factory.mktemp("counts"), timeout=600)


def test_per_device_flops_times_ranks_equal_one_device():
    """Each rank of the fake (2, 2) mesh runs a quarter of the products and
    kernel work of the one-device step (batch over "data", heads, d_ff and
    vocab over "a"), and every kernel call of it at local shapes."""
    flops22, calls22, coll22, _ = _fake_counts((2, 2))
    flops1, calls1, coll1, wire1 = _fake_counts(None)
    assert flops22 > 0 and 4 * flops22 == flops1
    assert calls22 == calls1 == {"flash_attention_fwd": 2}
    assert coll1 == {} and wire1 == 0
    assert coll22["all-reduce"] > 0
    assert _no_group()


def test_fake_counts_equal_a_real_gloo_run(real_counts):
    """The fake (2, 2) mesh counts what rank 0 of a real 4-rank gloo group
    runs for the same step: FLOPs, kernel op calls, collectives by op and
    their wire bytes; every rank counts the same."""
    fake = _fake_counts((2, 2))
    assert all(r == real_counts[0] for r in real_counts)
    assert real_counts[0] == fake


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def test_small_mesh_dryrun_cell():
    """The twin of the reference's: reduced qwen1.5-32b, 2 layers, a
    256-token 8-row train shape on a (2, 4) mesh, remat full, 2
    microbatches."""
    cfg = tcfg.reduced(tcfg.get_config("qwen1.5-32b"), num_layers=2)
    r = TD.lower_cell("qwen1.5-32b", "t", False,
                      {"remat": "full", "microbatches": 2, "skip_aux": True},
                      cfg=cfg, shape_cfg=tcfg.ShapeConfig("t", 256, 8,
                                                          "train"),
                      mesh_shape=(2, 4), device="cpu")
    assert r["status"] == "ok" and r["microbatches"] == 2
    assert r["memory"]["temp_size_in_bytes"] > 0
    assert r["chips"] == 8 and r["run_cfg"]["remat"] == "full"
    assert _no_group()


# arch: (mode, run overrides, kernel op calls).  The train cells run the
# arch's default remat (``default_run_overrides``): "dots" for the dense,
# moe, audio and vlm archs and "full" for ssm and hybrid, each of which
# recomputes every kernel call of a layer in the backward (zamba2's shared
# attention block is not rematerialised)
FAMILY_CASES = {
    "tinyllama-1.1b/train": ("tinyllama-1.1b", "train", {},
                             {"flash_attention_fwd": 4}),
    "tinyllama-1.1b/train-int8": ("tinyllama-1.1b", "train",
                                  {"opt_state_dtype": "int8"},
                                  {"flash_attention_fwd": 4}),
    "tinyllama-1.1b/prefill": ("tinyllama-1.1b", "prefill", {},
                               {"flash_attention_fwd": 2}),
    "tinyllama-1.1b/decode": ("tinyllama-1.1b", "decode", {}, {}),
    "deepseek-moe-16b/train": ("deepseek-moe-16b", "train", {},
                               {"flash_attention_fwd": 4}),
    "rwkv6-3b/train": ("rwkv6-3b", "train", {}, {"rwkv6_fused_fwd": 4}),
    "zamba2-2.7b/train": ("zamba2-2.7b", "train", {},
                          {"rwkv6_fused_fwd": 4, "flash_attention_fwd": 1}),
    "whisper-base/train": ("whisper-base", "train", {},
                           {"flash_attention_fwd": 12}),
    "phi-3-vision-4.2b/train": ("phi-3-vision-4.2b", "train", {},
                                {"flash_attention_fwd": 4}),
}


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_lower_cell_at_reduced_size(case):
    arch, mode, over, calls = FAMILY_CASES[case]
    cfg = tcfg.reduced(tcfg.get_config(arch))
    r = TD.lower_cell(arch, "t", False,
                      {**over, "microbatches": 1, "skip_aux": True},
                      cfg=cfg, shape_cfg=tcfg.ShapeConfig("t", 32, 4, mode),
                      mesh_shape=(2, 2), device="cpu")
    assert r["status"] == "ok", r
    assert r["kernel_op_calls"] == calls
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
    assert r["collectives"]["total_wire_bytes"] > 0
    roof = r["roofline"]
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["model_flops"] > 0 and roof["chips"] == 4
    assert r["memory"]["temp_size_in_bytes"] > 0
    assert r["memory"]["argument_size_in_bytes"] > 0
    if mode == "train":
        assert r["run_cfg"]["opt_state_dtype"] == over.get(
            "opt_state_dtype", "float32")
        assert r["opt_state_bytes"] > 0
    assert _no_group()


def test_int8_state_is_smaller_than_float32():
    """The int8 state a rank holds is near a quarter of float32's (q one
    byte a value, a float32 scale a block of 128; the leaves whose shards
    are not whole blocks keep whole rows on each rank)."""
    got = {}
    for od in ("float32", "int8"):
        got[od] = TD.lower_cell(
            "tinyllama-1.1b", "t", False,
            {"opt_state_dtype": od, "microbatches": 1, "skip_aux": True,
             "remat": "none"}, cfg=_tiny(d_model=256, head_dim=64, d_ff=512,
                                         vocab_size=512),
            shape_cfg=tcfg.ShapeConfig("t", 32, 4, "train"),
            mesh_shape=(2, 2), device="cpu")["opt_state_bytes"]
    assert got["int8"] < 0.35 * got["float32"]


def test_lower_cell_on_the_production_mesh():
    """16 x 16 fake ranks: a reduced tinyllama decode cell whose batch
    splits over "data" and whose heads and widths split over the model
    axis."""
    cfg = _tiny(num_heads=16, num_kv_heads=16, d_ff=256)
    r = TD.lower_cell("tinyllama-1.1b", "t", False, {"skip_aux": True},
                      cfg=cfg, shape_cfg=tcfg.ShapeConfig("t", 32, 16,
                                                          "decode"),
                      device="cpu")
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["mesh_shape"] == [16, 16]
    assert r["collectives"]["count"]
    assert _no_group()


def test_cell_supported_skips_long_500k_on_full_attention():
    r = TD.lower_cell("tinyllama-1.1b", "long_500k", False, device="cpu")
    assert r["status"] == "skipped" and "full-attention" in r["reason"]
    assert TD.cell_supported(tcfg.get_config("rwkv6-3b"), "long_500k") \
        is None
    assert _no_group()


def test_defaults_match_reference():
    from repro.launch import dryrun as JD
    for name in tcfg.list_configs():
        tc, jc = tcfg.get_config(name), jcfg.get_config(name)
        assert TD.default_run_overrides(tc) == JD.default_run_overrides(jc)
        assert TD._aux_depths(tc) == JD._aux_depths(jc)
        assert tc.active_param_count() == jc.active_param_count()
        for shape in tcfg.SHAPES:
            for dp in (1, 16, 32):
                assert TD.default_microbatches(
                    tc, tcfg.SHAPES[shape], dp) == JD.default_microbatches(
                        jc, jcfg.SHAPES[shape], dp)
            assert TD.cell_supported(tc, shape) == JD.cell_supported(
                jc, shape)


@pytest.mark.parametrize("mb", [1, 2])
def test_extrapolation_matches_the_direct_count(mb):
    """The reference's formula over the counts at depths 1 and 2 (and 2
    microbatches) gives the direct count at depth 3: FLOPs and collective
    bytes at 1 and 2 microbatches, bytes accessed at 1.  (At 2 it does not
    for bytes: the eager step's grad accumulators grow with depth, and the
    formula takes its per-layer slope at one microbatch, which has none.)"""
    r = TD.lower_cell("tinyllama-1.1b", "t", False,
                      {"microbatches": mb, "remat": "none"},
                      cfg=_tiny(num_layers=3),
                      shape_cfg=tcfg.ShapeConfig("t", 32, 8, "train"),
                      mesh_shape=(2, 2), device="cpu")
    ext, roof = r["extrapolation"], r["roofline"]
    assert (ext["L_a"], ext["L_b"], ext["mb_real"]) == (1, 2, mb)
    exact = [("flops", roof["hlo_flops"]), ("wire", roof["wire_bytes"]),
             ("operand_sum", r["collectives"]["total_operand_sum"])]
    if mb == 1:
        exact.append(("bytes", roof["hbm_bytes"]))
    for key, direct in exact:
        assert direct > 0
        assert abs(ext[key] - direct) <= 1e-6 * direct, key


def test_depth_cut_keeps_the_full_archs_defaults():
    """``layers`` cuts the arch in depth and records the cut; the
    microbatches and remat stay the full arch's (nemotron-4-340b: over
    100 B, one row a microbatch, remat full)."""
    big = tcfg.get_config("nemotron-4-340b")
    r = TD.lower_cell("nemotron-4-340b", "t", False, {"skip_aux": True},
                      shape_cfg=tcfg.ShapeConfig("t", 16, 8, "train"),
                      mesh_shape=(2, 2), layers=1, device="cpu")
    assert r["status"] == "ok"
    assert r["reduced"] == {"num_layers": [big.num_layers, 1]}
    assert r["microbatches"] == 4 and r["run_cfg"]["remat"] == "full"
    assert r["kernel_op_calls"] == {"flash_attention_fwd": 8}


# case: (arch, mode, microbatches, reduced-config overrides); each depth
# past the scaled count's second variant depth (hybrid: attn_every 2, so
# depths 4 and 6; moe with a first dense layer: 3 and 4; others 2 and 3)
SCALED_CASES = {
    "tinyllama-1.1b/train-mb1": ("tinyllama-1.1b", "train", 1,
                                 dict(num_layers=5)),
    "tinyllama-1.1b/train-mb3": ("tinyllama-1.1b", "train", 3,
                                 dict(num_layers=5)),
    "tinyllama-1.1b/decode": ("tinyllama-1.1b", "decode", 1,
                              dict(num_layers=5)),
    "deepseek-moe-16b/train-mb2": ("deepseek-moe-16b", "train", 2,
                                   dict(num_layers=6)),
    "zamba2-2.7b/train-mb2": ("zamba2-2.7b", "train", 2,
                              dict(num_layers=8)),
    "whisper-base/train-mb2": ("whisper-base", "train", 2,
                               dict(num_layers=4, encoder_layers=4)),
}


@pytest.mark.parametrize("case", list(SCALED_CASES))
def test_scaled_count_equals_the_full_count(case):
    arch, mode, mb, over = SCALED_CASES[case]
    kw = dict(cfg=tcfg.reduced(tcfg.get_config(arch), **over),
              shape_cfg=tcfg.ShapeConfig("t", 32, 12, mode),
              mesh_shape=(2, 2), device="cpu")
    scaled = TD.lower_cell(arch, "t", False,
                           {"count": "scaled", "microbatches": mb}, **kw)
    full = TD.lower_cell(arch, "t", False,
                         {"count": "full", "microbatches": mb,
                          "skip_aux": True}, **kw)
    assert (scaled["status"], full["status"]) == ("ok", "ok")
    assert scaled["roofline_count"] == "scaled"
    assert full["roofline_count"] == "full"
    for key in ("cost", "collectives", "kernel_op_calls", "ops",
                "roofline"):
        assert scaled[key] == full[key], key
    assert scaled.get("opt_state_bytes") == full.get("opt_state_bytes")
    sm, fm = scaled["memory"], full["memory"]
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert sm[key] == fm[key], key
    temp = fm["temp_size_in_bytes"]
    assert 0.85 * temp <= sm["temp_size_in_bytes"] <= temp
    assert _no_group()


def test_choose_count_scales_only_deep_cells():
    """auto: the full count up to ``FULL_COUNT_LIMIT`` layer-microbatches
    (tinyllama-1.1b train_4k pod: 22 x 2), scaled past it (qwen1.5-32b
    64 x 2, nemotron-4-340b 96 x 16 and its 96-layer prefill); a config no
    deeper than the second variant depth is always counted in full."""
    get = tcfg.get_config
    assert TD.FULL_COUNT_LIMIT == 64
    assert TD.choose_count(get("tinyllama-1.1b"), 2) == "full"
    assert TD.choose_count(get("qwen1.5-32b"), 2) == "scaled"
    assert TD.choose_count(get("nemotron-4-340b"), 16) == "scaled"
    assert TD.choose_count(get("nemotron-4-340b"), 1) == "scaled"
    assert TD.choose_count(get("tinyllama-1.1b"), 2, "scaled") == "scaled"
    assert TD.choose_count(get("nemotron-4-340b"), 16, "full") == "full"
    assert TD.choose_count(tcfg.reduced(get("tinyllama-1.1b")), 1,
                           "scaled") == "full"
    with pytest.raises(ValueError):
        TD.choose_count(get("tinyllama-1.1b"), 1, "both")
