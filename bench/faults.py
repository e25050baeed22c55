"""The control and the planted faults the check must catch, as hooks a
driver takes in place of the program's call (``kinds.train.Run(wrap_step=)``,
``kinds.prefill.Run(wrap_prefill=)``).  Used by ``bench/readings.py`` on the
card and by the tests under ``bench/tests``; never by a benchmark run."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from . import weights
from .kinds import common


def unchanged(step: Callable) -> Callable:
    """A training step that returns its state unchanged (and the step's
    own metrics)."""
    def faulty(params, opt, ef, batch):
        metrics = step(params, opt, ef, batch)[3]
        return params, opt, ef, metrics
    return faulty


def half_batch(step: Callable) -> Callable:
    """A training step that leaves half of the batch out: the mean is taken
    over the first half's rows."""
    def faulty(params, opt, ef, batch):
        return step(params, opt, ef, {k: v[:v.shape[0] // 2]
                                      for k, v in batch.items()})
    return faulty


def altered_token(prefill: Callable) -> Callable:
    """A prefill whose logits are moved one place along the vocabulary, so
    the first token is altered where it is produced."""
    def faulty(params, cfg, tokens, max_len):
        logits, state = prefill(params, cfg, tokens, max_len=max_len)
        return torch.roll(logits, 1, dims=-1), state
    return faulty


def reference_prefill(cfg: dict, seed: int, device, quant: str) -> Callable:
    """The control of a served model: the configuration's reference, with
    its products' operands rounded to ``quant``, put in the program's
    place; it returns the last position's logits and the K / V caches in
    the program's layout."""
    ref = common.reference(cfg)
    flat = dict(weights.flat_items(weights.make(
        cfg, seed, device, getattr(torch, cfg["serve"]["param_dtype"]))))

    def wrap(_prefill):
        def control(params, port_cfg, tokens, max_len):
            logits, kv = ref.prefill(cfg, flat, tokens, quant)
            state: Dict = {"k_cache": torch.stack([k for k, _ in kv])[:, None],
                           "v_cache": torch.stack([v for _, v in kv])[:, None]}
            return logits[None, None], state
        return control
    return wrap
