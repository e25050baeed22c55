"""Quickstart on the PyTorch port: the paper's pipeline in 60 lines.

1. build a 512-GPU Leaf-Spine cluster model,
2. submit a 64-GPU job to the isolated (vClos) scheduler,
3. verify the granted placement is contention-free for ring-allreduce AND
   pairwise AlltoAll (Lemma 5.1 / §5.3),
4. contrast with ECMP hash-collision contention on the same job,
5. train a small LM for a few steps on the granted placement, through the
   attention kernel on the card (its plain version with ``--device cpu``).

Steps 1-4 print what ``examples/quickstart.py`` prints.  Step 5's params
come from the port's ``init_lm(seed=0)``, so its losses are not the
reference's.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (CLUSTER512, IsolatedScheduler, contention,
                              halving_doubling_allreduce, pairwise_alltoall,
                              ring_allreduce)
from repro_torch.core.rankmap import leaf_contiguous_order
from repro_torch.core.routing import ECMPRouting

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

# -- 1-2: admission ----------------------------------------------------------
sched = IsolatedScheduler(CLUSTER512, strategy="vclos")
grant = sched.submit(job_id=0, num_gpus=64)
assert grant is not None
gpus = leaf_contiguous_order(grant.placement, CLUSTER512)
print(f"granted 64 GPUs on leafs "
      f"{sorted({CLUSTER512.leaf_of_gpu(g) for g in gpus})}")

# -- 3: contention-freedom under the grant's source routing -------------------
ring = ring_allreduce(gpus, nbytes=1e9)[0]
hd = halving_doubling_allreduce(gpus, nbytes=1e9)
a2a = pairwise_alltoall(gpus, nbytes=1e8)
print("ring contention-free:",
      contention(ring, grant.routing).is_contention_free)
print("halving-doubling contention-free:",
      all(contention(p, grant.routing).is_contention_free for p in hd))
print("alltoall contention-free:",
      all(contention(p, grant.routing).is_contention_free for p in a2a))

# -- 4: the same job under ECMP (across hash seeds, §3.1) ----------------------
# HD's cross-leaf steps put 32 simultaneous flows on each leaf's uplinks —
# ECMP hashing collides with near-certainty (birthday bound), SR never does.
collisions = sum(
    1 for seed in range(20)
    if any(not contention(p, ECMPRouting(CLUSTER512, seed=seed))
           .is_contention_free for p in hd))
print(f"ECMP on the same HD allreduce: hash collisions in {collisions}/20 "
      f"seeds (paper: >=31.5% even with tuned hashing)")

# -- 5: train on the granted placement ----------------------------------------
from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention
from repro_torch.models.transformer import init_lm
from repro_torch.train.optimizer import OptimizerConfig, adamw_init
from repro_torch.train.train_step import make_train_step

device = resolve_device(args.device)
cfg = reduced(get_config("tinyllama-1.1b"))
params = init_lm(cfg, 0, device=device)
opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=20)
step = make_train_step(cfg, opt_cfg)
opt = adamw_init(params, opt_cfg)
rng = np.random.default_rng(0)
toks = rng.integers(0, cfg.vocab_size, (4, 65))
batch = {"tokens": torch.as_tensor(toks[:, :-1], device=device),
         "labels": torch.as_tensor(toks[:, 1:], device=device)}
flash_attention.launches = 0
for i in range(5):
    params, opt, _, m = step(params, opt, None, batch)
    print(f"step {i}: loss {float(m['loss']):.4f}")
print(f"attention kernel launches: {flash_attention.launches} "
      f"({cfg.num_layers} layers x 5 steps on {device.type})")
sched.release(0)
print("released — cluster utilization:", sched.utilization())
