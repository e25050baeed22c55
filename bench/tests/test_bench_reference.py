"""The benchmark's plain references against the program at reduced sizes
on the CPU (the tests may import the program; the references may not),
and its configuration files against the program's registry."""

import dataclasses
import json

import pytest
import torch

from bench import reference, weights
from bench.kinds import common as kcommon
from bench.reference import common, dense, rwkv6
from bench.tests.tiny import ROOT, SIZES

CONFIGS = sorted(SIZES)


def tiny(name, dtype="float32"):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(SIZES[name], dtype=dtype)
    return cfg


def close(got, want, rtol):
    scale = want.abs().max().clamp_min(1e-30)
    return float((got - want).abs().max() / scale) <= rtol


@pytest.mark.parametrize("name", CONFIGS)
def test_tree_is_the_programs(name):
    """Paths, shapes and dtypes of the benchmark's weights are the
    program's own (the vlm stub frontend's patch_proj aside)."""
    from repro_torch.models.transformer import init_lm
    cfg = tiny(name)
    ours = {p: (tuple(t.shape), t.dtype)
            for p, t in weights.flat_items(weights.make(cfg, 1, "cpu"))}
    port = {p: (tuple(t.shape), t.dtype)
            for p, t in weights.flat_items(init_lm(kcommon.port_config(cfg),
                                                   1, device="cpu"))
            if p != "patch_proj"}
    assert ours == port


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_grads_match_the_program(name):
    from repro_torch.models.context import ModelContext
    from repro_torch.train.train_step import loss_and_grads
    cfg = tiny(name)
    b = weights.train_batch(3, 0, 2, 32, cfg["vocab_size"], "cpu")
    params = weights.make(cfg, 3, "cpu")
    loss, grads = loss_and_grads(kcommon.port_config(cfg), params,
                                 b["tokens"], b["labels"],
                                 ctx=ModelContext(ssm_chunk=16))
    ref = reference.module(cfg)
    flat = dict(weights.flat_items(weights.make(cfg, 3, "cpu")))
    rloss, rgrads = ref.loss_and_grads(cfg, flat, b["tokens"], b["labels"])
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    port = dict(weights.flat_items(grads))
    assert set(port) == set(rgrads)
    for path, g in rgrads.items():
        assert close(port[path], g, 1e-4), path


def test_prefill_matches_the_program():
    from repro_torch.serve.decode import prefill
    cfg = tiny("phi-3-vision-4.2b")
    tokens = weights.prompt(4, 0, 40, cfg["vocab_size"], "cpu")
    params = weights.make(cfg, 4, "cpu")
    logits, state = prefill(params, kcommon.port_config(cfg), tokens,
                            max_len=41)
    rlogits, kv = dense.prefill(cfg, dict(weights.flat_items(params)),
                                tokens)
    assert close(logits[0, 0], rlogits, 1e-5)
    for layer, (k, v) in enumerate(kv):
        assert close(state["k_cache"][layer, 0, :40], k, 1e-5)
        assert close(state["v_cache"][layer, 0, :40], v, 1e-5)


def test_adamw_matches_the_program():
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                             adamw_update)
    cfg = tiny("phi-3-vision-4.2b.pp2")
    opt = cfg["train"]["optimizer"]
    opt_cfg = OptimizerConfig(**opt)
    params = weights.make(cfg, 6, "cpu")
    state = adamw_init(params, opt_cfg)
    flat = {p: t.clone() for p, t in weights.flat_items(params)}
    m = {p: torch.zeros_like(t) for p, t in flat.items()}
    v = {p: torch.zeros_like(t) for p, t in flat.items()}
    gen = torch.Generator().manual_seed(0)
    for step in range(1, 4):
        gflat = {p: torch.randn(t.shape, generator=gen) * (0.5 if step == 2
                                                           else 0.01)
                 for p, t in flat.items()}
        params, state, _ = adamw_update(weights.nest(gflat), state, params,
                                        opt_cfg)
        common.adamw(flat, gflat, m, v, step, opt)
    for path, t in weights.flat_items(params):
        assert close(t, flat[path], 1e-6), path
    for path, t in weights.flat_items(state.m):
        assert close(t, m[path], 1e-6), path


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([1.0, 0.3, -0.02, 0.0])
    y = common.fp8(x)
    assert y[0] == 1.0 and y[3] == 0.0
    assert 0 < abs(float(y[1]) - 0.3) <= 0.3 / 16
    assert abs(float(y[2]) + 0.02) <= 0.02 / 16


@pytest.mark.parametrize("name", CONFIGS)
def test_config_files_are_the_registry_entry_but_for_their_cuts(name):
    from repro_torch.configs import get_config
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                     .read_text())
    ours, theirs = kcommon.port_config(cfg), get_config(cfg["port_config"])
    for field in dataclasses.fields(theirs):
        if field.name in cfg["reduced"] or field.name == "head_dim":
            continue
        assert getattr(ours, field.name) == getattr(theirs, field.name), \
            field.name
    assert ours.head_dim_ == theirs.head_dim_
    for key in cfg["reduced"]:
        assert cfg[key] < getattr(theirs, key)
    if cfg["family"] == "ssm":     # the decay's rank, fixed in the program
        from repro_torch.models.ssm import rwkv6_init
        p = rwkv6_init(torch.Generator(), 64, 16)
        assert p["w_decay_a"].shape[-1] == cfg["rwkv_decay_rank"]


@pytest.mark.parametrize("name", CONFIGS)
def test_each_family_is_laid_out_and_counted_by_its_module(name):
    """The configuration's reference module, and no other, lays out the
    block's leaves and counts its matrices and mixer."""
    from bench import counts
    cfg = tiny(name)
    mod = reference.module(cfg)
    assert mod is {"dense": dense, "rwkv6": rwkv6}[cfg["reference"]]
    paths = [p for p, _, _ in weights.leaf_specs(cfg)]
    assert paths[-len(mod.layer_leaves(cfg)):] == [
        p for p, _, _ in mod.layer_leaves(cfg)]
    assert counts.layer_matrices(cfg) == mod.layer_matrices(cfg)
    assert counts.mixer_fwd_flops(cfg, 2, 32, 16) == mod.mixer_fwd_flops(
        cfg, 2, 32, 16)


@pytest.mark.parametrize("family,ref", [("moe", "dense"),
                                        ("hybrid", "rwkv6"),
                                        ("dense", "rwkv6")])
def test_a_family_its_module_does_not_implement_is_refused(family, ref):
    """A configuration whose family its reference module does not name is
    refused by the weights and the counts alike, never taken as another
    family's."""
    from bench import counts
    cfg = dict(tiny("phi-3-vision-4.2b" if ref == "dense"
                    else "rwkv6-3b.pp2"), family=family, reference=ref)
    for call in (lambda: weights.leaf_specs(cfg),
                 lambda: counts.layer_matrices(cfg),
                 lambda: counts.train_step_flops(cfg, 2, 32, 16)):
        with pytest.raises(ValueError, match="family"):
            call()


def test_a_reference_that_is_not_there_is_refused():
    cfg = dict(tiny("phi-3-vision-4.2b"), reference="no_such_family")
    with pytest.raises(ModuleNotFoundError):
        weights.leaf_specs(cfg)
