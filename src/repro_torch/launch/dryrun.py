"""Parameter and decode-state placements for a sharded run: the part of the
reference's ``repro/launch/dryrun.py`` that its distributed tests and the
sharded serving path use (``_fsdp_spec``, ``sharded_param_specs``,
``decode_state_specs``).

The dry run itself (lower and compile every arch × shape × mesh cell, no
allocation) is slice 7 of the port (compile-only analysis): ``python -m
repro_torch.launch.dryrun`` exits 2 naming it, as ``sweep dryrun`` does.
"""

from __future__ import annotations

import math
import sys
from typing import Any, Dict, Tuple

import torch

from ..parallel.sharding import (_STACKED, DP, NamedSharding, P, _path_str,
                                 axis_sizes, param_spec, sanitize_spec)
from ..train.tree import tree_map_with_path

REFUSAL = ("dryrun: lowering and compiling model cells is slice 7 of the "
           "port (compile-only analysis, ROADMAP.md queue 1); this module "
           "has only sharded_param_specs and decode_state_specs so far.  Run the reference's "
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


# ---------------------------------------------------------------------------
# decode-state specs
# ---------------------------------------------------------------------------

_CACHES = ("k_cache", "v_cache", "k_cache_dense", "v_cache_dense",
           "cross_k", "cross_v")


def state_spec(name: str, leaf, batch: int, view) -> P:
    """The spec of one decode-state tensor on ``view`` (the reference's
    ``decode_state_specs.spec_for``): the batch over dp where it divides;
    caches (L, B, cap, Hkv, hd) with the cache's sequence over tp where it
    divides; ``rwkv_S`` / ``mamba_ssm`` (L, B, H, K, V) with the heads over
    "a" where they divide; ``tmix_last`` / ``cmix_last`` (L, B, D) with D
    over tp; ``mamba_conv`` (L, B, 3, D_in) with D_in over tp where it
    divides.  Scalars (``cache_len``, ``enc_len``, Python ints here) are
    ``P()``."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
        return P()
    sizes = axis_sizes(view)
    dp = tuple(n for n in sizes if n in DP)
    dp_axes = dp if len(dp) > 1 else dp[0]
    bshard = dp_axes if batch % math.prod(sizes[n] for n in dp) == 0 \
        else None
    tp = ("a", "b")
    tp_size = sizes["a"] * sizes["b"]
    if name in _CACHES:
        return P(None, bshard, tp if leaf.shape[2] % tp_size == 0 else None,
                 None, None)
    if name in ("rwkv_S", "mamba_ssm"):
        return P(None, bshard, "a" if leaf.shape[2] % sizes["a"] == 0
                 else None, None, None)
    if name in ("tmix_last", "cmix_last"):
        return P(None, bshard, tp)
    if name == "mamba_conv":
        return P(None, bshard, None,
                 tp if leaf.shape[3] % tp_size == 0 else None)
    return P(*([None] * leaf.ndim))


def decode_state_specs(cfg, shape_cfg, view
                       ) -> Tuple[Dict[str, Any], Dict[str, NamedSharding]]:
    """(the decode state on the ``meta`` device, its shardings): the
    reference's ``decode_state_specs``, the state of ``shape_cfg``'s global
    batch and a capacity of its ``seq_len``, bf16, as ``NamedSharding``s of
    :func:`state_spec` on ``view``."""
    from ..serve.kv_cache import init_decode_state
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    state = init_decode_state(cfg, b, s, dtype=torch.bfloat16, device="meta")
    return state, {k: NamedSharding(view, state_spec(k, v, b, view))
                   for k, v in state.items()}


def main(argv=None) -> None:
    print(REFUSAL, file=sys.stderr)
    raise SystemExit(2)


if __name__ == "__main__":
    main()
