"""The benchmark's operation and byte counts against hand counts at small
shapes, and against the program's own FLOP formulas where both count the
same work."""

import json
import math

import pytest

from bench import counts, weights
from bench.tests.tiny import ROOT, SIZES


def brute_pairs(sq, skv, causal, window):
    return sum(1 for i in range(sq) for j in range(skv)
               if (not causal or j <= i) and (not window or i - j < window))


@pytest.mark.parametrize("sq,skv,causal,window", [
    (1, 1, True, None), (7, 7, True, None), (5, 9, True, None),
    (9, 5, True, None), (6, 4, False, None), (8, 8, True, 3),
    (12, 12, False, 5)])
def test_live_pairs(sq, skv, causal, window):
    assert counts.live_pairs(sq, skv, causal, window) == brute_pairs(
        sq, skv, causal, window)


def test_attention_counts_by_hand():
    # B 1, 4 queries causal: 1 + 2 + 3 + 4 = 10 pairs; Hq 2, hd 8
    assert counts.attn_fwd_flops(1, 4, 4, 2, 8) == 4 * 2 * 8 * 10
    assert counts.attn_bwd_flops(1, 4, 4, 2, 8) == 2 * 4 * 2 * 8 * 10
    # q and o (4 x 2 x 8) and k, v (4 x 1 x 8), bf16
    assert counts.attn_fwd_bytes(1, 4, 4, 2, 1, 8, 2) == 2 * (64 + 64 + 32
                                                              + 32)
    # q, o, dO, dq and k, v, dk, dv
    assert counts.attn_bwd_bytes(1, 4, 4, 2, 1, 8, 2) == 2 * (4 * 64
                                                              + 4 * 32)


def test_recurrence_counts_by_hand():
    # one (B, H), T 4, K = V = 2, chunk 2: two chunks, one strict pair each
    products, other, nbytes = counts.rwkv6_fwd_work(1, 4, 2, 2, 2, 1, 2)
    assert products == 2 * (2 * 1 * 4 + 4 * 2 * 2 * 2)
    assert other == 2 * 2 * 2 + 4 * (3 * 2 + 2 * 2)
    # q, k, decay (4 x 2 each) and v, out (4 x 2) in bf16; S float32;
    # the bonus (1 x 2) float32
    assert nbytes == 2 * (3 * 8 + 2 * 8) + 4 * 4 + 4 * 2
    assert counts.rwkv6_scan_flops(1, 4, 2, 2, 2) == 4 * (2 * 2 * 4
                                                          + 4 * 2 * 2)


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, bf16=989e12 / 2) == 1.0
    assert counts.least_seconds(3.35e12 / 2, bf16=989e12) == 1.0
    assert counts.least_seconds(0, tf32x3=495e12 / 3, f32=67e12) == 2.0


def tiny(name):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(SIZES[name])
    return cfg


def test_model_flops_by_hand():
    cfg = tiny("phi-3-vision-4.2b.pp2")      # L 2, d 64, 4 x 16, d_ff 128
    mats = 2 * (2 * 64 * 64 + 2 * 64 * 64 + 3 * 64 * 128)
    head = 64 * 256
    attn = 2 * 4 * 2 * 4 * 16 * (32 * 33 // 2)  # L, 4 B Hq hd, pairs
    assert counts.layer_matrices(cfg) == mats
    assert counts.train_step_flops(cfg, 2, 32) == 6 * (mats + head) * 64 \
        + 3 * attn
    assert counts.prefill_flops(cfg, 32) == 2 * mats * 32 + attn // 2 \
        + 2 * head
    rw = tiny("rwkv6-3b.pp2")                 # 4 heads of 16, rank 64
    mats = 2 * (4 * 64 * 64 + 2 * 64 * 64 + 2 * 64 * 128)
    scan = 2 * (2 * 4) * 32 * (2 * 16 * 32 + 4 * 16 * 16)
    assert counts.train_step_flops(rw, 2, 32, 16) == 6 * (mats + head) * 64 \
        + 3 * scan


@pytest.mark.parametrize("name", sorted(SIZES))
def test_param_count_is_the_tree(name):
    cfg = tiny(name)
    tree = weights.make(cfg, 5, "cpu")
    assert counts.param_count(cfg) == sum(
        t.numel() for _, t in weights.flat_items(tree))


def test_counts_agree_with_the_programs_formulas():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6
    for shape in [(4, 2048, 2048, 32, 96, True, None),
                  (1, 300, 700, 8, 64, False, None),
                  (2, 512, 512, 4, 128, True, 100)]:
        b, sq, skv, hq, hd, causal, window = shape
        assert counts.attn_fwd_flops(b, sq, skv, hq, hd, causal, window) \
            == fa.flops(b, sq, skv, hq, hd, causal, window)
    assert counts.rwkv6_scan_flops(160, 2048, 64, 64, 16) == rwkv6.flops(
        4, 40, 2048, 64, 64, 16)


def test_full_size_counts_are_plausible():
    """The full configurations: the published parameter counts of the
    held stages and of the whole model, and a step's model FLOPs."""
    phi = json.loads((ROOT / "bench/configs/phi-3-vision-4.2b.pp2.json")
                     .read_text())
    rw = json.loads((ROOT / "bench/configs/rwkv6-3b.pp2.json").read_text())
    assert math.isclose(counts.param_count(phi), 2.0087e9, rel_tol=1e-3)
    assert math.isclose(counts.param_count(rw), 1.5997e9, rel_tol=1e-3)
    assert math.isclose(counts.train_step_flops(phi, 4, 2048), 9.878e13,
                        rel_tol=1e-3)
    whole = json.loads((ROOT / "bench/configs/phi-3-vision-4.2b.json")
                       .read_text())
    assert math.isclose(counts.param_count(whole), 3.8211e9, rel_tol=1e-3)
