"""Deterministic synthetic LM data pipeline: the port's own copy of
``repro/data/pipeline.py`` (numpy only), so that it imports nothing of the
reference.  Batches are bit-identical to the reference's, the ``np.uint64``
seed arithmetic included (``tests/test_torch_train.py`` holds them).

Produces reproducible token streams (hash-mixed positions: no RNG state to
checkpoint beyond the step counter) with a simple background prefetch.  A
real deployment swaps ``SyntheticSource`` for a tokenised corpus reader.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structured synthetic data: repeated n-grams make loss measurably drop
    ngram: int = 8


class SyntheticSource:
    """Deterministic function of (step, row): restart-safe by construction."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.uint64(c.seed * 0x9E3779B9 + step * 0x85EBCA6B) % (2**63))
        base = rng.integers(0, c.vocab_size,
                            size=(c.global_batch, c.seq_len // c.ngram + 1,
                                  c.ngram // 2))
        # learnable structure: each half-ngram is repeated
        block = np.concatenate([base, base], axis=-1)
        toks = block.reshape(c.global_batch, -1)[:, :c.seq_len + 1]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Single background thread keeping ``depth`` batches ready.  A context
    manager: leaving the ``with`` block stops the thread and joins it."""

    def __init__(self, source: SyntheticSource, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(depth)   # free places in q
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._slots.acquire(timeout=0.1):
                if self._stop.is_set():
                    return
            self.q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self.q.get()
        self._slots.release()
        return item

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)   # the worker wakes every 0.1 s

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
