"""Training launcher: scheduler-granted placement -> rank order -> train loop.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --batch 4 --seq 2048 --steps 5

The paper's workflow, as ``repro.launch.train`` walks it: the job is
submitted to the IsolatedScheduler for the requested GPU count; the grant's
leaf-contiguous rank order is verified ring-leafwise (contention-free
collectives per Lemma 5.1) and becomes the device order; the model trains
from float32 masters (random weights from seed 0) on ``SyntheticSource``
batches with AdamW, with checkpoint / restart when ``--ckpt-dir`` is given.
The model runs on one device, ``cuda`` unless ``--device cpu`` is given:
the attention kernel (dense) or the recurrence kernel (ssm) runs in every
forward, their backward recomputes through the plain formulation.
``main`` returns the ``LoopReport``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..configs import get_config, reduced
from ..core import CLUSTER512, CLUSTER512_OCS, IsolatedScheduler
from ..core.rankmap import leaf_contiguous_order, verify_ring_leafwise
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..kernels import flash_attention as fa
from ..kernels import rwkv6
from ..models.context import REMAT_POLICIES, ModelContext
from ..models.transformer import init_lm
from ..train.loop import LoopConfig, LoopReport, run_training
from ..train.optimizer import OptimizerConfig
from ..train.train_step import make_train_step


def main(argv: Optional[Sequence[str]] = None) -> LoopReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--gpus", type=int, default=64)
    ap.add_argument("--strategy", default="vclos",
                    choices=["vclos", "ocs-vclos"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=REMAT_POLICIES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. cluster-level admission: isolated placement for the job
    spec = CLUSTER512_OCS if args.strategy == "ocs-vclos" else CLUSTER512
    sched = IsolatedScheduler(spec, strategy=args.strategy)
    grant = sched.submit(job_id=0, num_gpus=args.gpus)
    if grant is None:
        raise SystemExit(f"cluster cannot place {args.gpus} GPUs "
                         f"({sched.last_failure} fragmentation)")
    order = leaf_contiguous_order(grant.placement, spec)
    print(f"[train] granted {len(grant.placement.gpus)} GPUs, kind="
          f"{grant.placement.kind}; ring leaf-wise="
          f"{verify_ring_leafwise(order, spec)}")

    # 2. model + data
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = init_lm(cfg, 0, device=device)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                              total_steps=args.steps)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    step = make_train_step(cfg, opt_cfg, ctx=ModelContext(remat=args.remat),
                           microbatches=args.microbatches,
                           grad_compression=args.grad_compression)

    # 3. train with fault tolerance
    fa.launches = rwkv6.launches = 0
    report = run_training(cfg, step, params, opt_cfg, data_cfg,
                          LoopConfig(total_steps=args.steps,
                                     ckpt_every=50 if args.ckpt_dir else 0,
                                     ckpt_dir=args.ckpt_dir),
                          grad_compression=args.grad_compression)
    print(f"[train] done on {device}: {report.steps_run} steps, "
          f"final loss {report.final_loss:.4f}, "
          f"stragglers {report.straggler_steps}")
    for name, mod in (("flash-attention", fa), ("rwkv6", rwkv6)):
        print(f"[train] {name} kernel launches: {mod.launches}")
    sched.release(0)
    return report


if __name__ == "__main__":
    main()
