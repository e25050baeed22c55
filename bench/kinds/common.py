"""What the drivers share: the program's model configuration, per-leaf
norms, the comparison's gaps, and the reference's module."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, Tuple

import torch

from .. import weights
from ..reference import module as ref_module

Unit = Tuple[str, int]      # (leaf path, layer index; -1 for unstacked)


def port_config(cfg: dict):
    """The program's ModelConfig of the configuration file ``cfg``: every
    field the file gives, under the program's registry name."""
    from repro_torch.configs import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    fields = {k: v for k, v in cfg.items() if k in names and k != "name"}
    return ModelConfig(name=cfg["port_config"], **fields)


def reference(cfg: dict):
    return ref_module(cfg)


@torch.no_grad()
def unit_norms(flat: Dict[str, torch.Tensor]) -> Dict[Unit, float]:
    """The norm of every leaf, each layer of a stacked leaf apart."""
    out: Dict[Unit, float] = {}
    for path, t in flat.items():
        t = t.float()
        if path.startswith("layers/"):
            norms = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1)
            for i, n in enumerate(norms.tolist()):
                out[(path, i)] = n
        else:
            out[(path, -1)] = float(torch.linalg.vector_norm(t))
    return out


@torch.no_grad()
def change_norms(cfg: dict, seed: int, flat: Dict[str, torch.Tensor],
                 device) -> Dict[Unit, float]:
    """The norm of each unit's change from the starting weights, which are
    drawn again from the seed leaf by leaf."""
    out: Dict[Unit, float] = {}
    for path, t in flat.items():
        start = weights.make_leaf(cfg, seed, path, device)
        out.update(unit_norms({path: t.float() - start}))
        del start
    return out


def unit_gaps(got: Dict[Unit, float], want: Dict[Unit, float],
              units=None) -> Dict[Unit, float]:
    """Each unit's |got - want| against the larger of its own reference
    norm and the median unit's."""
    units = list(want) if units is None else list(units)
    med = statistics.median(want[u] for u in units)
    return {u: abs(got.get(u, 0.0) - want[u]) / max(want[u], med, 1e-30)
            for u in units}


def unit_name(u: Unit) -> str:
    return f"{u[0]}[{u[1]}]" if u[1] >= 0 else u[0]
