"""A copy of the benchmark at a size the CPU runs in seconds: the same
files, with the configurations, mixes and windows cut down."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "src"

SIZES = {
    "phi-3-vision-4.2b": dict(num_layers=2, d_model=64, num_heads=4,
                              num_kv_heads=4, head_dim=16, d_ff=128,
                              vocab_size=256),
    "phi-3-vision-4.2b.pp2": dict(num_layers=2, d_model=64, num_heads=4,
                                  num_kv_heads=4, head_dim=16, d_ff=128,
                                  vocab_size=256),
    "rwkv6-3b.pp2": dict(num_layers=2, d_model=64, rwkv_head_dim=16,
                         num_heads=4, num_kv_heads=4, d_ff=128,
                         vocab_size=256),
}
TRAFFIC = {
    "train.4x2048": dict(batch=2, seq=32),
    "prefill.256-4096": dict(trace_seconds=0.05),
}
PREFILL_LENGTHS = dict(median=48, min=16, max=128, round=16, pool=16)
PREFILL_CHECK = dict(logit_sample=6, caches=3, cache_from_first=4)
# The limits of the cut-down copy, on the numbers each cell compares.  At
# this size bf16 rounding weighs more than at the cells' own, so the cells'
# limits would fail sound runs here; these were set as the cells' were,
# from readings at this size (CPU, seeds 1, 2, 3, 2**33 + 5, 2**40 + 1; the
# control and the faults on 1, 2, 2**33 + 5), sound maximum / least of the
# control or a fault: phi3v train loss 7.0e-4 / 1.2e-3, grad 3.7e-3 /
# 2.6e-2, change 1.3e-3 / 7.2e-3; rwkv6 train grad p90 3.0e-2 / 9.3e-2,
# change 1.7e-2 / 3.7e-2; prefill logit gap 0 / 2.0 (altered token), kv
# 9.1e-3 / 0.117.
LIMITS = {
    "phi3v.train.4x2048": dict(loss_gap=2e-3, grad_gap=1e-2,
                               change_gap=4e-3),
    "rwkv6.train.4x2048": dict(grad_gap_p90=5.5e-2, change_gap=2.7e-2),
    "phi3v.prefill.256-4096": dict(logit_gap=0.5, kv_err=0.05),
}


def _edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data, indent=1))


def make_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and a cut-down ``bench/``."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, sizes in SIZES.items():
        _edit(tmp / "bench" / "configs" / f"{name}.json", **sizes)
    for name, changes in TRAFFIC.items():
        path = tmp / "bench" / "traffic" / f"{name}.json"
        data = json.loads(path.read_text())
        if data["kind"] == "prefill":
            data["lengths"].update(PREFILL_LENGTHS)
            data["check"].update(PREFILL_CHECK)
        data.update(changes)
        path.write_text(json.dumps(data, indent=1))
    for name, limits in LIMITS.items():
        (tmp / "bench" / "limits" / f"{name}.json").write_text(
            json.dumps(limits))
    return tmp


def cells() -> list:
    return [w["name"] for w in
            json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
