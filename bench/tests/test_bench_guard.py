"""A run of every traffic mix, set-up, a step and the check, at a tiny size
on the CPU, in a process of its own: it loads no module whose top-level
name is jax, jaxlib, flax or repro (repro_torch is the program), and reads
nothing of the JAX era's benchmark (benchmarks/, BENCH_*.json,
scripts/bench_gate.py)."""

import json
import os
import subprocess
import sys

from bench.tests.tiny import ROOT, cells, make_root

CHILD = r"""
import json, os, sys, time
from pathlib import Path
opened = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        opened.append(os.fsdecode(args[0]))

sys.addaudithook(hook)
tmp, repo, names = sys.argv[1], sys.argv[2], sys.argv[3:]
sys.path[:0] = [repo, os.path.join(repo, "src")]
import torch
from bench import harness
for name in names:
    cell = harness.Cell(name, root=Path(tmp))
    harness.run_cell(cell, 2**31 + 7, 0.0, False, torch.device("cpu"),
                     time.perf_counter())
print(json.dumps({"roots": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def test_runs_load_no_jax_and_read_no_jax_era_benchmark(tmp_path):
    make_root(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp_path), str(ROOT), *cells()],
        capture_output=True, text=True, timeout=600, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {"jax", "jaxlib", "flax", "repro"} & set(seen["roots"])
    assert "repro_torch" in seen["roots"]
    forbidden = [str(ROOT / "benchmarks"), str(ROOT / "BENCH_"),
                 str(ROOT / "scripts" / "bench_gate.py")]
    read = [p for p in seen["opened"]
            if any(p.startswith(f) for f in forbidden)]
    assert not read
