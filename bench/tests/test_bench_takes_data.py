"""A new cell, traffic mix, configuration and per-layer metric are taken
from new files alone: a copy of the benchmark gains them, the files it
already had stay byte for byte, and a run reports the new cell's
metrics."""

import hashlib
import json
import time

import torch

from bench import harness
from bench.tests.tiny import make_root

METRIC = '''"""Steps the traced segment ran."""

RANGES = {}


def read(view):
    if view.kind != "train":
        return None
    return float(view.segment["steps"])
'''


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_alone_add_a_cell(tmp_path):
    make_root(tmp_path)
    before = digest(tmp_path)
    bench = tmp_path / "bench"
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = json.loads((bench / "configs" / "phi-3-vision-4.2b.pp2.json")
                     .read_text())
    cfg.update(name="dense-test", num_layers=1)
    (bench / "configs" / "dense-test.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "train.2x16-test.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "seq": 16, "follow_steps": 2,
         "trace_steps": 1}))
    (bench / "metrics" / "steps-test.train.py").write_text(METRIC)
    (bench / "limits" / "dense-test.train.json").write_text(json.dumps(
        {"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.05}))
    spec["configs"].append({"name": "dense-test", "source": "test",
                            "file": "bench/configs/dense-test.json",
                            "reduced": ["num_layers"], "why": "test"})
    spec["workloads"].append({"name": "dense-test.train",
                              "config": "dense-test",
                              "traffic": "train.2x16-test", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "steps-test.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "model step",
                              "moves": "train_tokens_per_s",
                              "workloads": ["dense-test.train"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("train_tokens_per_s", "mfu.train"):
            m["workloads"].append("dense-test.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.Cell("dense-test.train", root=tmp_path)
    cpu = torch.device("cpu")
    plain = harness.run_cell(cell, 11, 0.0, False, cpu, time.perf_counter())
    assert set(plain["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert set(plain["checked"]) == {"loss_gap", "grad_gap", "change_gap"}
    traced = harness.run_cell(cell, 12, 0.0, True, cpu, time.perf_counter())
    assert traced["metrics"]["steps-test.train"]["value"] == 1.0
    assert "mfu.train" in traced["metrics"]
    after = digest(tmp_path)
    assert all(after[p] == h for p, h in before.items() if p.name !=
               "BENCHMARK.json")
