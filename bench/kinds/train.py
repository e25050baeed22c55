"""Closed loop of training steps: ``make_train_step``'s step, batch after
batch, until the window ends.

Set-up builds one training step with its weights and AdamW state from the
seed and drives it through its first ``follow_steps`` steps on batches
that all differ, through the same call and feed as the window.  The
reference follows those steps after the window: each step's loss, the
first gradient as the optimizer gets it (worked out from AdamW's first
moment after one step), and each leaf's change after the last of them, as
the following step would find it.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional

import torch

from .. import weights
from ..reference import common as ref_common
from . import common


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 wrap_step: Optional[Callable] = None):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.batch, self.seq = traffic["batch"], traffic["seq"]
        self.opt = cfg["train"]["optimizer"]
        self.wrap_step = wrap_step
        self.next_index = 0
        self.gen = torch.Generator(device=device)
        self.readings: Dict = {}
        self.window_stats: Dict = {}

    # -- the program -------------------------------------------------------

    def _batch(self):
        b = weights.train_batch(self.seed, self.next_index, self.batch,
                                self.seq, self.cfg["vocab_size"], self.device,
                                self.gen)
        self.next_index += 1
        return b

    def build(self):
        """The program's training step and its state from the seed."""
        from repro_torch.models.context import ModelContext
        from repro_torch.train.optimizer import OptimizerConfig, adamw_init
        from repro_torch.train.train_step import make_train_step
        tr = self.cfg["train"]
        opt_cfg = OptimizerConfig(**self.opt)
        step = make_train_step(common.port_config(self.cfg), opt_cfg,
                               ctx=ModelContext(remat=tr["remat"],
                                                ssm_chunk=tr["ssm_chunk"]))
        params = weights.make(self.cfg, self.seed, self.device,
                              getattr(torch, tr["param_dtype"]))
        return step, (params, adamw_init(params, opt_cfg), None)

    def setup(self) -> None:
        step, self.state = self.build()
        self.step = step if self.wrap_step is None else self.wrap_step(step)
        losses = []
        for i in range(self.traffic["follow_steps"]):
            *self.state, metrics = self.step(*self.state, self._batch())
            losses.append(float(metrics["loss"]))
            if i == 0:
                self.readings["grad"] = self._first_grad(metrics)
        self.readings["loss"] = losses
        self.readings["change"] = common.change_norms(
            self.cfg, self.seed, dict(weights.flat_items(self.state[0])),
            self.device)

    def _first_grad(self, metrics) -> Dict:
        """Each unit's first gradient, before clipping: AdamW's first
        moment after one step is (1 - b1) x scale x g, scale the clipping
        factor of the step's global gradient norm."""
        gnorm, clip = float(metrics["grad_norm"]), self.opt["clip_norm"]
        scale = min(clip / (gnorm + 1e-9), 1.0) if clip > 0 else 1.0
        m = dict(weights.flat_items(self.state[1].m))
        return {u: n / ((1 - self.opt["b1"]) * scale)
                for u, n in common.unit_norms(m).items()}

    def _one_step(self):
        self.state = self.step(*self.state, self._batch())[:3]
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        ends = []
        while True:
            self._one_step()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        steps, elapsed = len(ends), ends[-1]
        self.window_stats = {"steps": steps, "seconds": elapsed,
                             "ends": ends}
        return {"train_tokens_per_s": steps * self.batch * self.seq / elapsed}

    def trace_segment(self) -> Dict:
        """The traced steps, whole."""
        n = self.traffic["trace_steps"]
        for _ in range(n):
            self._one_step()
        return {"steps": n}

    def release(self) -> None:
        self.state = self.step = None

    # -- the check ---------------------------------------------------------

    def follow(self, quant: Optional[str] = None) -> Dict:
        """The reference's readings over the first ``follow_steps`` batches,
        in float32 (or with fp8 operands: the control)."""
        ref_common.no_tf32()
        ref = common.reference(self.cfg)
        flat = dict(weights.flat_items(
            weights.make(self.cfg, self.seed, self.device)))
        m = {p: torch.zeros_like(t) for p, t in flat.items()}
        v = {p: torch.zeros_like(t) for p, t in flat.items()}
        out: Dict = {"loss": []}
        for i in range(self.traffic["follow_steps"]):
            b = weights.train_batch(self.seed, i, self.batch, self.seq,
                                    self.cfg["vocab_size"], self.device)
            loss, grads = ref.loss_and_grads(self.cfg, flat, b["tokens"],
                                             b["labels"], quant)
            out["loss"].append(float(loss))
            if i == 0:
                out["grad"] = common.unit_norms(grads)
            ref_common.adamw(flat, grads, m, v, i + 1, self.opt)
            del grads
        del m, v
        out["change"] = common.change_norms(self.cfg, self.seed, flat,
                                            self.device)
        return out

    def check(self) -> Dict[str, float]:
        self.reference = self.follow()
        return compare(self.readings, self.reference)


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a train cell's limits may compare: the worst step's loss
    gap relative to the reference's loss; of the units' first-gradient
    norm gaps, the worst and the 90th percentile; the same of the units'
    weight-change gaps, over the units whose reference gradient is at
    least a thousandth of the median unit's (the others move by round-off
    alone; ``left_out`` counts them)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       ref["loss"]))
    med = statistics.median(ref["grad"].values())
    moved = [u for u, n in ref["grad"].items() if n >= 1e-3 * med]
    grad = list(common.unit_gaps(got["grad"], ref["grad"]).values())
    change = list(common.unit_gaps(got["change"], ref["change"],
                                   moved).values())
    return {"loss_gap": loss_gap, "grad_gap": max(grad),
            "grad_gap_p90": p90(grad), "change_gap": max(change),
            "change_gap_p90": p90(change),
            "left_out": float(len(ref["grad"]) - len(moved))}


def p90(values) -> float:
    return statistics.quantiles(values, n=10)[-1]


def worst_units(got: Dict, ref: Dict, k: int = 5) -> Dict[str, list]:
    """The ``k`` units of largest gradient and change gaps, for a look at
    what a number reads."""
    out = {}
    for key in ("grad", "change"):
        gaps = common.unit_gaps(got[key], ref[key])
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:k]
        out[key] = [[common.unit_name(u), g, ref[key][u]] for u, g in top]
    return out
