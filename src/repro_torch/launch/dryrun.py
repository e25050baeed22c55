"""Parameter placements for a sharded run: the part of the reference's
``repro/launch/dryrun.py`` that its distributed tests use (``_fsdp_spec``,
``sharded_param_specs``).

The dry run itself (lower and compile every arch × shape × mesh cell, no
allocation) is slice 7 of the port (compile-only analysis): ``python -m
repro_torch.launch.dryrun`` exits 2 naming it, as ``sweep dryrun`` does.
"""

from __future__ import annotations

import sys
from typing import Any

from ..parallel.sharding import (_STACKED, NamedSharding, P, _path_str,
                                 axis_sizes, param_spec, sanitize_spec)
from ..train.tree import tree_map_with_path

REFUSAL = ("dryrun: lowering and compiling model cells is slice 7 of the "
           "port (compile-only analysis, ROADMAP.md queue 1); this module "
           "has only sharded_param_specs so far.  Run the reference's "
           "`python -m repro.launch.dryrun` for the dry run")


# ---------------------------------------------------------------------------
# FSDP augmentation of parameter specs
# ---------------------------------------------------------------------------

def _fsdp_spec(spec: P, leaf, view, stacked_hint: bool) -> P:
    """Insert the "data" (FSDP) axis into the first unsharded dim that
    divides evenly: ZeRO-3-style weight sharding on top of TP."""
    data = axis_sizes(view).get("data", 1)
    if data <= 1 or leaf.ndim == 0 or leaf.numel() < (1 << 16):
        return spec
    entries = list(spec) + [None] * (leaf.ndim - len(spec))
    start = 1 if stacked_hint and leaf.ndim >= 2 else 0
    for d in range(start, leaf.ndim):
        if entries[d] is None and leaf.shape[d] % data == 0:
            entries[d] = "data"
            return P(*entries)
    return spec


def sharded_param_specs(params_abs, cfg, view, fsdp: bool = True) -> Any:
    """:class:`NamedSharding` tree of the parameter tree: the TP rules,
    sanitized, then FSDP over "data" (``fsdp``)."""
    def one(path, leaf):
        spec = sanitize_spec(param_spec(path, leaf, cfg), leaf, view)
        if fsdp:
            stacked = bool(_STACKED.search(_path_str(path)))
            spec = _fsdp_spec(spec, leaf, view, stacked)
        return NamedSharding(view, spec)
    return tree_map_with_path(one, params_abs)


def main(argv=None) -> None:
    print(REFUSAL, file=sys.stderr)
    raise SystemExit(2)


if __name__ == "__main__":
    main()
