"""Training loop: prefetched data, periodic checkpoints, fault tolerance.

The port of ``repro/train/loop.py``:
  * auto-resume from the latest committed checkpoint (torn writes skipped);
  * a step-time watchdog: steps slower than ``straggler_factor x`` the
    running median (once 5 step times exist) are logged and counted; on a
    real cluster the hook triggers re-dispatch or a hot-spare swap;
  * checkpoints every ``ckpt_every`` steps and keep-N garbage collection.

A step's time ends after ``torch.cuda.synchronize`` on the card (the
reference reads ``float(metrics["loss"])`` for the same effect).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..data.pipeline import DataConfig, Prefetcher, SyntheticSource
from ..device import is_dtensor
from . import checkpoint as ckpt
from .compression import ef_init
from .optimizer import OptimizerConfig, adamw_init
from .tree import Tree, leaves


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


@dataclass
class LoopReport:
    steps_run: int = 0
    final_loss: float = float("nan")
    losses: List[float] = field(default_factory=list)
    straggler_steps: int = 0
    resumed_from: Optional[int] = None
    step_times: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)


def run_training(cfg, train_step: Callable, params: Tree,
                 opt_cfg: OptimizerConfig, data_cfg: DataConfig,
                 loop_cfg: LoopConfig, grad_compression: bool = False,
                 shardings=None,
                 log: Callable[[str], None] = print) -> LoopReport:
    """``shardings`` (a tree of ``parallel.sharding.NamedSharding``) lays a
    resumed checkpoint out on the current mesh (``checkpoint.restore``)."""
    report = LoopReport()
    opt_state = adamw_init(params, opt_cfg)
    ef_state = ef_init(params) if grad_compression else None
    start_step = 0
    first = leaves(params)[0]
    device = first.to_local().device if is_dtensor(first) else first.device

    if loop_cfg.ckpt_dir:
        resumed = ckpt.restore_latest(loop_cfg.ckpt_dir, params, opt_state,
                                      shardings)
        if resumed is not None:
            start_step, params, opt_state, _meta = resumed
            report.resumed_from = start_step
            log(f"[loop] resumed from step {start_step}")

    times: List[float] = []
    with Prefetcher(SyntheticSource(data_cfg),
                    start_step=start_step) as prefetch:
        for step, batch in prefetch:
            if step >= loop_cfg.total_steps:
                break
            t0 = time.perf_counter()
            params, opt_state, ef_state, metrics = train_step(
                params, opt_state, ef_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            loss = float(metrics["loss"])
            times.append(dt)
            report.step_times.append(dt)
            report.grad_norms.append(float(metrics["grad_norm"]))
            if len(times) >= 5:
                med = float(np.median(times[-50:]))
                if dt > loop_cfg.straggler_factor * med:
                    report.straggler_steps += 1
                    log(f"[loop] straggler at step {step}: {dt:.3f}s "
                        f"(median {med:.3f}s): re-dispatch hook fired")
            report.losses.append(loss)
            report.steps_run = step + 1
            if loop_cfg.log_every and step % loop_cfg.log_every == 0:
                log(f"[loop] step {step} loss {loss:.4f} "
                    f"({dt:.2f}s, lr {float(metrics.get('lr', 0)):.2e})")
            if (loop_cfg.ckpt_dir and loop_cfg.ckpt_every
                    and (step + 1) % loop_cfg.ckpt_every == 0):
                ckpt.save(loop_cfg.ckpt_dir, step + 1, params, opt_state)
                ckpt.gc_old(loop_cfg.ckpt_dir, keep=loop_cfg.keep_ckpts)
    report.final_loss = report.losses[-1] if report.losses else float("nan")
    return report
