"""Contention analysis (paper §3) on the PyTorch port: hash-collision
probability, scaling factor degradation, and two-flow sensitivity — the
measurement study that motivates vClos, reproduced on the port's fabric
model (``repro_torch.core``, numpy only).  Its output equals
``examples/contention_analysis.py``'s.

Run:  PYTHONPATH=src python examples/contention_analysis_torch.py
"""
import argparse

import numpy as np

from repro_torch.core import CLUSTER512
from repro_torch.core.jobs import Job
from repro_torch.core.routing import ECMPRouting, SourceRouting, contention
from repro_torch.core.traffic import Flow, ring_allreduce

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                help="accepted for symmetry with the other examples: the "
                     "study runs on the host")
ap.parse_args()

spec = CLUSTER512
print("== §3.1 hash-collision probability (random cross-leaf permutations)")
rng = np.random.default_rng(0)
coll = 0
trials = 40
for t in range(trials):
    perm = rng.permutation(spec.num_gpus)
    phase = [Flow(i, int(perm[i]), 1.0) for i in range(spec.num_gpus)
             if spec.leaf_of_gpu(i) != spec.leaf_of_gpu(int(perm[i]))]
    if not contention(phase, ECMPRouting(spec, seed=t)).is_contention_free:
        coll += 1
print(f"  contention in {coll}/{trials} trials "
      f"({100*coll/trials:.0f}%; paper: ≥31.5% even with tuned hashing)")

print("== §3.2 scaling factor: ring allreduce under ECMP vs SR")
for n in (16, 32, 64, 128):
    phase = ring_allreduce(list(range(n)), 1.0)[0]
    worst = max(contention(phase, ECMPRouting(spec, seed=s)).max_load
                for s in range(10))
    sr = contention(phase, SourceRouting(spec)).max_load
    print(f"  n={n:4d}: ECMP worst link load {worst}, source-routing {sr}")

print("== §3.3 two-flow contention sensitivity per model")
for model, batch in (("vgg16", 32), ("resnet50", 32), ("bert", 4),
                     ("moe", 8), ("dlrm", 256)):
    j = Job(0, model, 8, batch, 0.0, 1)
    drop = 1 - j.iter_time(1.0) / j.iter_time(0.5)
    print(f"  {model:10s} bs={batch:4d}: throughput drop {100*drop:.0f}%")
