"""A prefill pool: one client in a closed loop, sending one prompt a call
(batch 1) to ``serve/decode.py::prefill`` and taking the argmax of its
logits, the first token.  The program's prefill takes one rectangular
batch at a time, with no queue or batcher, so the mix sets no client count
or batch.

The prompt lengths are a fixed multiset that the traffic file sets (the
quantiles of a clipped log-normal, rounded), the same for every seed; the
seed shuffles their order anew each pass and draws the prompts' tokens.
Set-up warms each distinct length once.  The check runs the reference over
a sample of the window's requests, drawn from the seed with the longest
among them: the widest gap by which a served token's logit lies below the
reference's best, and, for a few requests whose caches are kept as
``prefill`` returned them, the worst layer's K or V cache against the
reference's.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import weights
from ..reference import common as ref_common
from . import common


def lengths(spec: dict) -> List[int]:
    """The multiset of prompt lengths: the quantiles (i + 1/2) / n of a
    log-normal of the given median and sigma, rounded to a multiple of
    ``round`` and clipped to [min, max]."""
    n, mu, sigma = spec["pool"], math.log(spec["median"]), spec["sigma"]
    nd = statistics.NormalDist(mu, sigma)
    out = []
    for i in range(n):
        x = math.exp(nd.inv_cdf((i + 0.5) / n))
        x = spec["round"] * round(x / spec["round"])
        out.append(int(min(max(x, spec["min"]), spec["max"])))
    return out


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 wrap_prefill: Optional[Callable] = None):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.pool = lengths(traffic["lengths"])
        self.wrap_prefill = wrap_prefill
        self.served: List[Dict] = []     # every request of the window
        self.kept: Dict[int, Dict] = {}
        self.next_index = 0
        self.gen = torch.Generator(device=device)
        self.window_stats: Dict = {}

    def length_of(self, i: int) -> int:
        n = len(self.pool)
        order = torch.randperm(n, generator=weights.generator(
            self.seed, f"order/{i // n}", "cpu"))
        return self.pool[int(order[i % n])]

    # -- the program -------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.serve.decode import prefill
        self.port_cfg = common.port_config(self.cfg)
        self.params = weights.make(self.cfg, self.seed, self.device,
                                   getattr(torch,
                                           self.cfg["serve"]["param_dtype"]))
        self.prefill = (prefill if self.wrap_prefill is None
                        else self.wrap_prefill(prefill))
        for s in sorted(set(self.pool)):
            self._call(weights.prompt(self.seed, -s, s,
                                      self.cfg["vocab_size"], self.device,
                                      self.gen))
        # requests whose caches are kept for the check: the first of the
        # longest length, and some of the first requests, drawn from the seed
        first = self.traffic["check"]["cache_from_first"]
        longest = next(i for i in range(10 * len(self.pool))
                       if self.length_of(i) == max(self.pool))
        pick = torch.randperm(first, generator=weights.generator(
            self.seed, "cache_sample", "cpu"))
        self.keep = {longest, *(int(i) for i in
                                pick[:self.traffic["check"]["caches"] - 1])}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _call(self, tokens):
        s = tokens.shape[1]
        logits, state = self.prefill(self.params, self.port_cfg, tokens,
                                     max_len=s + 1)
        return int(logits[0, -1].argmax()), state

    def _request(self) -> float:
        i = self.next_index
        self.next_index += 1
        s = self.length_of(i)
        tokens = weights.prompt(self.seed, i, s, self.cfg["vocab_size"],
                                self.device, self.gen)
        self._sync()
        t0 = time.perf_counter()
        token, state = self._call(tokens)
        t1 = time.perf_counter()
        self.served.append({"index": i, "length": s, "token": token,
                            "ttft": t1 - t0, "end": t1})
        if i in self.keep:
            self.kept[i] = {"k": state["k_cache"], "v": state["v_cache"]}
        return t1

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        while self._request() - t0 < seconds:
            pass
        elapsed = time.perf_counter() - t0
        ttft = sorted(r["ttft"] for r in self.served)
        tokens = sum(r["length"] for r in self.served)
        self.window_stats = {"requests": len(self.served), "seconds": elapsed,
                             "lengths": [r["length"] for r in self.served],
                             "ends": [r["end"] - t0 for r in self.served]}
        return {"prefill_tokens_per_s": tokens / elapsed,
                "ttft_ms_p95": 1e3 * percentile(ttft, 95)}

    def trace_segment(self) -> Dict:
        """Whole requests for ``trace_seconds``."""
        t0 = time.perf_counter()
        before = len(self.served)
        while self._request() - t0 < self.traffic["trace_seconds"]:
            pass
        return {"lengths": [r["length"] for r in self.served[before:]]}

    def release(self) -> None:
        self.params = self.prefill = None

    # -- the check ---------------------------------------------------------

    def sample(self) -> List[Dict]:
        """The requests the check compares: the longest served, then others
        drawn from the seed, ``logit_sample`` in all."""
        window = self.served[:self.window_stats["requests"]]
        longest = max(window, key=lambda r: r["length"])
        rest = [r for r in window if r is not longest]
        order = torch.randperm(len(rest), generator=weights.generator(
            self.seed, "logit_sample", "cpu"))
        n = self.traffic["check"]["logit_sample"] - 1
        return [longest] + [rest[int(j)] for j in order[:n]]

    def check(self) -> Dict[str, float]:
        ref_common.no_tf32()
        ref = common.reference(self.cfg)
        flat = dict(weights.flat_items(weights.make(
            self.cfg, self.seed, self.device,
            getattr(torch, self.cfg["serve"]["param_dtype"]))))
        if not self.kept:
            return {"logit_gap": float("inf"), "kv_err": float("inf")}
        gap, kv_err = 0.0, 0.0
        reqs = {r["index"]: r for r in self.sample()}
        reqs.update({r["index"]: r for r in self.served
                     if r["index"] in self.kept})
        for i, r in reqs.items():
            tokens = weights.prompt(self.seed, i, r["length"],
                                    self.cfg["vocab_size"], self.device)
            logits, kv = ref.prefill(self.cfg, flat, tokens)
            gap = max(gap, float(logits.max() - logits[r["token"]]))
            if i in self.kept:
                kv_err = max(kv_err, cache_error(self.kept[i], kv,
                                                 r["length"]))
        return {"logit_gap": gap, "kv_err": kv_err}


def cache_error(kept: Dict, kv, length: int) -> float:
    """The worst layer's K or V: ||cache - reference|| / ||reference|| over
    the prompt's slots."""
    worst = 0.0
    for layer, (k, v) in enumerate(kv):
        for name, want in (("k", k), ("v", v)):
            got = kept[name][layer, 0, :length].float()
            worst = max(worst, float(torch.linalg.vector_norm(got - want)
                                     / torch.linalg.vector_norm(want)))
    return worst


def percentile(sorted_values: List[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    pos = (len(sorted_values) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (
        pos - lo)
