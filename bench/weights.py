"""Weights and inputs made from the seed, the same for the program and the
reference.

Every random leaf and every batch is drawn by a ``torch.Generator`` of its
own on the device, seeded from (seed, name), so one leaf can be drawn again
alone: the reference and the checks remake the starting weights leaf by
leaf instead of keeping a copy.  The layout is the program's parameter
tree: nested dicts, a stacked leading layer axis on every layer leaf, and
(d_in, d_out) matrices.  Each leaf is drawn in float32, scaled in place and
cast once to the dtype it is held in.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

from . import reference

# norm parameters, which the program reads in float32 whatever the served
# dtype is; a reference module names its own such leaves
FLOAT32_LEAVES = ("scale", "bias")


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device,
              reuse: torch.Generator = None) -> torch.Generator:
    """The generator of stream ``name``: a new one, or ``reuse`` seeded
    anew (a driver's loop draws every request's inputs through one)."""
    gen = torch.Generator(device=device) if reuse is None else reuse
    return gen.manual_seed(stream_seed(seed, name))


def norm_leaves(prefix: str, kind: str, lead: tuple, d: int):
    """A norm's scale and, for a layernorm, its bias."""
    out = [(f"{prefix}/scale", (*lead, d), ("const", 1.0))]
    if kind == "layernorm":
        out.append((f"{prefix}/bias", (*lead, d), ("const", 0.0)))
    return out


def matrix(path: str, lead: tuple, d_in: int, d_out: int):
    """A (d_in, d_out) matrix under ``lead``, drawn at std 1/sqrt(d_in)."""
    return path, (*lead, d_in, d_out), ("normal", 1 / math.sqrt(d_in))


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(path, shape, init) of every leaf in the program's order; init is
    ("normal", std) or ("const", value).  The embedding, the final norm,
    the head and each block's two norms are common to every family; the
    configuration's reference module lays out the rest of a block."""
    d, v, L = cfg["d_model"], cfg["vocab_size"], (cfg["num_layers"],)
    out = [("embed", (v, d), ("normal", 0.02))]
    out += norm_leaves("ln_f", cfg["norm"], (), d)
    out.append(("lm_head", (d, v), ("normal", 1 / math.sqrt(d))))
    out += norm_leaves("layers/ln1", cfg["norm"], L, d)
    out += norm_leaves("layers/ln2", cfg["norm"], L, d)
    return out + reference.module(cfg).layer_leaves(cfg)


def held_dtype(cfg: dict, path: str, dtype: torch.dtype) -> torch.dtype:
    name = path.rsplit("/", 1)[-1]
    held = FLOAT32_LEAVES + reference.module(cfg).FLOAT32_LEAVES
    return torch.float32 if name in held else dtype


def make_leaf(cfg: dict, seed: int, path: str, device,
              dtype=torch.float32) -> torch.Tensor:
    """Leaf ``path`` of ``make(cfg, seed, device, dtype)``, drawn alone."""
    for p, shape, init in leaf_specs(cfg):
        if p == path:
            return _draw(seed, p, shape, init, device,
                         held_dtype(cfg, p, dtype))
    raise KeyError(path)


def _draw(seed, path, shape, init, device, dtype) -> torch.Tensor:
    kind, value = init
    if kind == "const":
        return torch.full(shape, value, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator(seed, path, device),
                    device=device, dtype=torch.float32)
    return w.mul_(value).to(dtype)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = t
    return tree


def flat_items(tree: dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def make(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The parameter tree of ``cfg`` from ``seed``: matrices in ``dtype``,
    the norms and the reference module's FLOAT32_LEAVES in float32."""
    return nest({p: _draw(seed, p, shape, init, device,
                          held_dtype(cfg, p, dtype))
                 for p, shape, init in leaf_specs(cfg)})


def train_batch(seed: int, index: int, batch: int, seq: int, vocab: int,
                device, reuse: torch.Generator = None
                ) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of a training run: B rows of S + 1 token ids drawn
    uniformly from the vocabulary; tokens are the first S, labels the
    last S."""
    ids = torch.randint(0, vocab, (batch, seq + 1),
                        generator=generator(seed, f"batch/{index}", device,
                                            reuse),
                        device=device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def prompt(seed: int, index: int, length: int, vocab: int,
           device, reuse: torch.Generator = None) -> torch.Tensor:
    """Request ``index``'s prompt: (1, length) token ids drawn uniformly."""
    return torch.randint(0, vocab, (1, length),
                         generator=generator(seed, f"prompt/{index}", device,
                                             reuse),
                         device=device)
