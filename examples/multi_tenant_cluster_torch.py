"""Multi-tenant cluster study on the PyTorch port: replay a job stream
under every scheduling strategy and reproduce the paper's headline
ordering (Fig. 12/13).  Each simulation resolves its flow rates through the
segment-max kernel on the card (its plain version with ``--device cpu``);
the table equals ``examples/multi_tenant_cluster.py``'s apart from the
wall-clock column, and the last line counts the kernel's launches against
the engines' solves.

Uses the first-class workload API (`WorkloadSpec` → `generate_trace`) and
the strategy registry — any plugin name from
`python -m repro_torch.launch.sweep campaign --list-strategies` drops into
the strategy tuple below.

Run:  PYTHONPATH=src python examples/multi_tenant_cluster_torch.py \\
          [--jobs 300] [--device cpu]
"""
import argparse
import time

from repro_torch.core import (CLUSTER512, CLUSTER512_OCS, WorkloadSpec,
                              generate_trace, simulate)
from repro_torch.core import simulator
from repro_torch.device import resolve_device
from repro_torch.kernels import phase_max

ap = argparse.ArgumentParser()
ap.add_argument("--jobs", type=int, default=300)
ap.add_argument("--lam", type=float, default=120.0)
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()
device = resolve_device(args.device)

jobs = generate_trace(WorkloadSpec(num_jobs=args.jobs,
                                   mean_interarrival=args.lam, seed=0))
print(f"{args.jobs} jobs, Poisson λ={args.lam}s, CLUSTER512")
print(f"{'strategy':20s} {'Avg.JRT':>10s} {'Avg.JWT':>10s} {'Avg.JCT':>10s} "
      f"{'Stability':>10s} {'frag g/n':>9s}")
simulator.solves = phase_max.launches = 0
for strat in ("best", "ocs-vclos", "vclos", "sr", "balanced",
              "contention-affinity", "ecmp"):
    spec = CLUSTER512_OCS if strat == "ocs-vclos" else CLUSTER512
    t0 = time.time()
    rep = simulate(spec, jobs, strat, device=device)
    print(f"{strat:20s} {rep.avg_jrt:10.1f} {rep.avg_jwt:10.1f} "
          f"{rep.avg_jct:10.1f} {rep.stability:10.1f} "
          f"{rep.frag_gpu:4d}/{rep.frag_network:<4d} [{time.time()-t0:.1f}s]")
print(f"segment-max kernel launches: {phase_max.launches} of "
      f"{simulator.solves} solves on {device.type}")
