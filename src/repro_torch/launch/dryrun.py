"""Multi-pod dry run: every (arch × shape × mesh) cell counted at the work
one device does, with no allocation and no launch.  The port of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell with XLA against abstract
inputs and reads the compiled module.  PyTorch compiles nothing, so a cell
here runs its step once on fake tensors:

  1. a fake process group of the production mesh's size (16 x 16 single pod,
     2 x 16 x 16 multi-pod; the ``fake`` backend of
     ``torch.testing._internal.distributed.fake_pg``) if none exists, and the
     mesh on it (``launch/mesh.py``, ``cuda`` as the mesh device); the
     group is destroyed on every way out, so a process that runs a cell can
     run a real group afterwards;
  2. the arch's mesh view and sharding rules (``parallel/sharding.py``), the
     params as fake DTensors in their shards (bf16, as the reference's), the
     shape's inputs or decode state, the AdamW state (float32, bf16 or
     blockwise int8);
  3. the train step (train shapes), a prefill forward or a decode step run
     once under ``FakeTensorMode`` and ``launch/hlo_analysis.py``'s
     :class:`Recorder`, which counts every op at the shapes rank 0 runs it:
     FLOPs, bytes, collectives, the kernels' registered op calls, memory;
  4. those counts, the roofline terms of the H100 and the cell's timings
     into ``artifacts/dryrun_torch/<cell>.json``, under the reference's JSON
     keys (``artifacts/dryrun/`` is the reference's).

The modelled device is the H100.  A fake tensor holds no memory and a fake
kernel call launches nothing (the kernels run behind registered ops whose
fake kernels give only shapes, ``kernels/ops.py``), so a cell needs no card:
``--device cuda`` needs a PyTorch built with CUDA, and ``--device cpu`` runs
the same count on a CPU-only build (the ops dispatch alike).

Differences from the reference, each deliberate:
  * The count is exact at full depth: the port's layers and microbatches are
    a Python loop, and the recorder sees every iteration, where XLA's
    ``cost_analysis`` counts a ``while`` body once.  ``roofline`` is that
    count (``roofline_count`` "full"), or, where the full-depth step would
    run more than ``FULL_COUNT_LIMIT`` layer-microbatches, the step counted
    at two depths and up to three microbatch counts and scaled
    (``roofline_count`` "scaled", :func:`scale_counts`): equal to the full
    count in FLOPs, bytes and collectives by op, since every layer and every
    microbatch after the first runs the same ops.  The reference's formula
    (``extrapolate_roofline``, its only source) is recorded under
    ``extrapolation`` as a check.
  * The reference's XLA-tiling fields (``block_q``, ``block_k``,
    ``full_unroll``) and ``_aux_ctx``'s larger chunk for the unrolled
    variants exist to bound XLA's compile time.  The port has none of them
    and no ``_aux_ctx``: its attention forward is the kernel (work = live
    pairs, whatever the tiles) and its backward recomputes at
    ``blocked_attention``'s own 512 tiles, so the variants run the cell's
    own context.
  * ``memory`` comes from the recorder, not ``MemTracker``: under DTensor
    ``MemTracker`` also counts the global-shape tensors of DTensor's
    sharding propagation, which no rank holds.
  * ``compile_s`` is the recorded run's wall time and ``lower_s`` the
    set-up's (mesh, fake params, state); ``hlo_bytes`` is absent, and
    ``ops`` counts the recorded ops instead.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
      --shape train_4k --mesh pod            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""

from __future__ import annotations

import argparse
import dataclasses as _dc
import json
import math
import os
import time
import traceback
from fractions import Fraction
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import SHAPES, get_config, list_configs
from ..configs.base import RunConfig
from ..parallel.sharding import (_STACKED, DP, NamedSharding, P, _path_str,
                                 abstract_params, axis_sizes, make_context,
                                 param_spec, sanitize_spec)
from ..train.tree import flatten, leaves, tree_map_with_path
from .hlo_analysis import (CollectiveStats, Recorder, Roofline, cost_summary,
                           memory_summary)

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"


def cell_supported(cfg, shape_name: str) -> Optional[str]:
    """long_500k is only runnable on sub-quadratic archs (DESIGN.md §5)."""
    if shape_name == "long_500k" and not get_config(cfg.name).sub_quadratic:
        return ("full-attention arch: 500k-token KV cache/score matrix is "
                "unbounded — skipped per DESIGN.md §5")
    return None


def default_microbatches(cfg, shape_cfg, dp: int) -> int:
    """Grad-accumulation factor: one microbatch of a row per DP shard for
    the memory-bound cells (over 100 B params, or sequences over 8192),
    else an eighth of a shard's rows."""
    per_dp = max(shape_cfg.global_batch // dp, 1)
    if cfg.param_count() > 100e9 or shape_cfg.seq_len > 8192:
        return per_dp
    return max(per_dp // 8, 1)


def default_run_overrides(cfg) -> Dict[str, Any]:
    """Per-arch execution defaults: full remat for 100B+ archs and the ssm
    and hybrid families, ``dots`` for the other dense and moe archs."""
    big = cfg.param_count() > 100e9
    if big or cfg.family in ("ssm", "hybrid"):
        return {"remat": "full"}
    return {"remat": "dots"}


# ---------------------------------------------------------------------------
# FSDP augmentation of parameter specs
# ---------------------------------------------------------------------------

def _fsdp_spec(spec: P, leaf, view, stacked_hint: bool,
               numel: Optional[int] = None) -> P:
    """Insert the "data" (FSDP) axis into the first unsharded dim that
    divides evenly: ZeRO-3-style weight sharding on top of TP.  ``numel``:
    the size that decides whether the leaf is large enough (default the
    leaf's own)."""
    data = axis_sizes(view).get("data", 1)
    numel = leaf.numel() if numel is None else numel
    if data <= 1 or leaf.ndim == 0 or numel < (1 << 16):
        return spec
    entries = list(spec) + [None] * (leaf.ndim - len(spec))
    start = 1 if stacked_hint and leaf.ndim >= 2 else 0
    for d in range(start, leaf.ndim):
        if entries[d] is None and leaf.shape[d] % data == 0:
            entries[d] = "data"
            return P(*entries)
    return spec


def sharded_param_specs(params_abs, cfg, view, fsdp: bool = True,
                        numels: Optional[Dict[str, int]] = None) -> Any:
    """:class:`NamedSharding` tree of the parameter tree: the TP rules,
    sanitized, then FSDP over "data" (``fsdp``).  ``numels`` ({path: size})
    decides FSDP by other sizes than the leaves' own: a cell counted at a
    cut depth is laid out as the full depth is."""
    def one(path, leaf):
        spec = sanitize_spec(param_spec(path, leaf, cfg), leaf, view)
        if fsdp:
            stacked = bool(_STACKED.search(_path_str(path)))
            spec = _fsdp_spec(spec, leaf, view, stacked,
                              None if numels is None else numels[path])
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


# ---------------------------------------------------------------------------
# the fake world: a process group, tensors and state that hold nothing
# ---------------------------------------------------------------------------

class FakeWorld:
    """A fake process group of ``world`` ranks, this process rank 0, for
    the block.  It is made only if no group exists, and then destroyed when
    the block is left, however it is left.  Meshes are made inside it and
    outside ``FakeTensorMode`` (a mesh reads its rank tensor's values)."""

    def __init__(self, world: int):
        self.world = world
        self.made = False

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if not dist.is_initialized():
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=self.world)
            self.made = True
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        if self.made:
            dist.destroy_process_group()
        return False


class Failure:
    """Records an ``Exception`` raised in its block as ``error`` and
    ``traceback`` (the reference records a failed cell as an artifact with
    status "error": a bug to fix) and lets anything else through."""

    def __init__(self):
        self.error = None
        self.traceback = None

    def __enter__(self):
        return self

    def __exit__(self, typ, exc, tb):
        if exc is None or not isinstance(exc, Exception):
            return False
        self.error = f"{typ.__name__}: {exc}"
        self.traceback = "".join(
            traceback.format_exception(typ, exc, tb))[-4000:]
        return True


def check_device(device: str) -> torch.device:
    """The fake tensors' device: ``cuda`` (the H100 the cell models) needs a
    PyTorch built with CUDA, not a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "dryrun: --device cuda needs a PyTorch built with CUDA (a fake "
            "cuda tensor needs no card); pass --device cpu on a CPU-only "
            "build")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"dryrun: no path for device {dev}")
    return dev


def _local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            if out[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split evenly {mesh.size(i)} ways")
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def fake_dtensor(shape, dtype, device, mesh, placements):
    """An empty DTensor of global ``shape`` laid out as ``placements`` on
    ``mesh`` (inside ``FakeWorld``: fake, each rank's shard)."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(_local_shape(shape, mesh, placements), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def fake_params(cfg, view, device, dtype, layout_cfg=None):
    """(params as DTensors in their shards, their ``sharded_param_specs``);
    with no ``view``, (plain fake params, None).  ``layout_cfg``: the config
    whose leaf sizes decide FSDP (the full depth of a cut config)."""
    abstract = abstract_params(cfg, dtype=dtype)
    if view is None:
        return tree_map_with_path(lambda path, leaf: torch.empty(
            leaf.shape, dtype=leaf.dtype, device=device), abstract), None
    numels = None if layout_cfg is None else {
        path: leaf.numel() for path, leaf in flatten(abstract_params(
            layout_cfg, dtype=dtype))}
    shard = sharded_param_specs(abstract, cfg, view, numels=numels)
    shard_of = dict(flatten(shard))
    params = tree_map_with_path(
        lambda path, leaf: fake_dtensor(
            leaf.shape, leaf.dtype, device, shard_of[path].device_mesh,
            shard_of[path].placements), abstract)
    return params, shard


def fake_batch(cfg, shape_cfg, device) -> Dict[str, torch.Tensor]:
    """The shape's inputs (``input_specs``' tensors) as fake tensors, every
    rank holding the global batch, as ``SyntheticSource`` gives it."""
    from ..parallel.sharding import input_specs
    return {n: torch.zeros(x.shape, dtype=x.dtype, device=device)
            for n, x in input_specs(cfg, shape_cfg).items()}


def _local_bytes(tree) -> int:
    """Bytes a rank holds of a tree's tensors (a DTensor's local shard)."""
    from ..device import is_dtensor
    total = 0
    for x in leaves(tree) if isinstance(tree, dict) else tree:
        for t in (x if isinstance(x, tuple) else (x,)):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if is_dtensor(t) else t
                total += t.numel() * t.element_size()
    return total


def _state_bytes(state) -> int:
    return _local_bytes([state.step, *leaves(state.m), *leaves(state.v)])


# ---------------------------------------------------------------------------
# counts at two depths: the scaled count, and the reference's extrapolation
#
# The port's layers and microbatches are a Python loop whose every iteration
# runs the same ops, so a cell's counts are linear in depth (per layer, or
# per group of ``attn_every`` layers), and from the second microbatch on
# linear in microbatches (the first has no accumulator to add into).  The
# scaled count runs the step at two depths (``_scale_depths``: each with
# layers before and after the one that repeats), and at up to three
# microbatch counts, and scales them to the full cell exactly:
#     f(L, m) = f(L_a, m) + (L − L_a)·(f(L_b, m) − f(L_a, m)) / (L_b − L_a)
#     f(L, k) = f(L, 2) + (k − 2) · (f(L, 3) − f(L, 2))        (k ≥ 3)
# for every count: FLOPs, bytes, ops, kernel op calls, collectives by op
# and the argument and state bytes.  The peak memory is scaled the same
# way, which is exact only where it grows linearly with depth.  Each
# variant is laid out as the full depth is (FSDP decides by the full
# leaves' sizes).
#
# The reference compiles small fully-unrolled variants at two depths (and
# two grad-accumulation factors) and extrapolates linearly, because
# cost_analysis counts a `while` body once:
#     total(L, mb) = opt + mb · [loss(L_a) + (L − L_a) · per_layer]
# Its formula over its own depths (``_aux_depths``) is recorded under
# ``extrapolation`` beside either count unless ``skip_aux``; it misses the
# eager step's grad accumulators in bytes.
# ---------------------------------------------------------------------------

# A cell counts its step at full depth when that runs at most this many
# layer-microbatches, and is scaled from two depths otherwise (a layer and
# microbatch costs about 2.5 s of host time on fake tensors).
FULL_COUNT_LIMIT = 64


def _aux_depths(cfg) -> Tuple[int, int]:
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every
    if cfg.family == "moe" and cfg.moe_first_dense:
        return cfg.moe_first_dense + 1, cfg.moe_first_dense + 2
    return 1, 2


def _small_cfg(cfg, L: int):
    kw: Dict[str, Any] = {"num_layers": L}
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = L
    return _dc.replace(cfg, **kw)


def _layer_steps(cfg, microbatches: int) -> int:
    """Layers (the encoder's too) times microbatches: what a count costs."""
    layers = cfg.num_layers + (cfg.encoder_layers if cfg.is_encoder_decoder
                               else 0)
    return layers * microbatches


def choose_count(cfg, microbatches: int, count: str = "auto") -> str:
    """"full" or "scaled": ``count`` itself, or under "auto" "scaled" where
    the full-depth step would run more than ``FULL_COUNT_LIMIT``
    layer-microbatches.  A config no deeper than its second variant
    depth is always counted in full."""
    if count not in ("auto", "full", "scaled"):
        raise ValueError(f"dryrun: unknown count {count!r}")
    if cfg.num_layers <= _scale_depths(cfg)[1]:
        return "full"
    if count == "auto":
        return "scaled" if _layer_steps(cfg, microbatches) > \
            FULL_COUNT_LIMIT else "full"
    return count


def counts_of(run: Dict[str, Any]) -> Dict[str, float]:
    """One recorded run (:func:`count_step`) as a flat {name: number}."""
    rec = run["recorder"]
    stats = rec.stats()
    out = {"flops": rec.flops, "bytes": rec.bytes, "ops": rec.ops,
           "temp": rec.peak_bytes,
           "argument_bytes": run["argument_bytes"],
           "output_bytes": run["output_bytes"],
           "opt_state_bytes": run.get("opt_state_bytes", 0)}
    out.update({f"op_calls/{k}": n for k, n in rec.op_calls.items()})
    for field in ("count", "operand_sum", "wire_bytes"):
        out.update({f"{field}/{k}": v
                    for k, v in getattr(stats, field).items()})
    return out


def stats_of(counts: Dict[str, float]) -> CollectiveStats:
    """The collectives by op of :func:`counts_of`'s (or scaled) counts."""
    stats = CollectiveStats()
    for key, v in counts.items():
        field, _, kind = key.partition("/")
        if field in ("count", "operand_sum", "wire_bytes"):
            getattr(stats, field)[kind] = v
    return stats


def _line(a: Dict, b: Dict, t) -> Dict[str, float]:
    """a + t·(b − a) per key, exactly (``Fraction``), ints kept ints."""
    out = {}
    for k in set(a) | set(b):
        x, y = Fraction(a.get(k, 0)), Fraction(b.get(k, 0))
        v = x + t * (y - x)
        out[k] = int(v) if v.denominator == 1 else float(v)
    return out


def scale_counts(at: Dict[Tuple[int, int], Dict], L: int, La: int, Lb: int,
                 mb: int) -> Dict[str, float]:
    """The counts at depth ``L`` and ``mb`` microbatches from the variants
    ``at[(depth, microbatches)]`` (the section's formula)."""
    def depth(m):
        return _line(at[(La, m)], at[(Lb, m)], Fraction(L - La, Lb - La))
    if mb <= 2:
        return depth(mb)
    return _line(depth(2), depth(3), mb - 2)


def _scale_depths(cfg) -> Tuple[int, int]:
    """The scaled count's two depths: one step of :func:`_aux_depths`
    deeper, so that the slope between them is a layer (or group) with
    layers on both sides, as most of the full depth's are."""
    La, Lb = _aux_depths(cfg)
    return Lb, 2 * Lb - La


def count_variants(cfg, shape_cfg, ctx, mb_real: int, microbatch_counts,
                   depths, *, opt_dtype: str = "float32",
                   param_dtype=torch.bfloat16, device="cuda"
                   ) -> Tuple[Dict[Tuple[int, int], Dict[str, float]], float]:
    """:func:`counts_of` of the step at each of the two ``depths`` and each
    of ``microbatch_counts``, a microbatch of the full cell's rows each,
    laid out as ``cfg``'s full depth is, on the full depth's context
    ``ctx`` (its mesh view does not depend on depth).  The first variant
    runs twice and its first count is dropped: a process's first backward
    records a few hundred one-off ops (fake-tensor work on first sight of
    an op), which a slope between two variants would multiply by the
    depth.  Returns the counts by (depth, microbatches) and the recorded
    runs' seconds."""
    b_micro = max(shape_cfg.global_batch // mb_real, 1)
    plan = [(L, m) for L in depths for m in microbatch_counts]
    out, run_s = {}, 0.0
    for L, m in plan[:1] + plan:
        small = _small_cfg(cfg, L)
        rows = m * b_micro if shape_cfg.mode == "train" else \
            shape_cfg.global_batch
        run = count_step(small, _dc.replace(shape_cfg, global_batch=rows),
                         ctx, microbatches=m, opt_dtype=opt_dtype,
                         param_dtype=param_dtype, device=device,
                         layout_cfg=cfg)
        out[(L, m)] = counts_of(run)
        run_s += run["run_s"]
    return out, run_s


def extrapolate_roofline(cfg, shape_cfg, ctx, mb_real: int, *,
                         opt_dtype: str = "float32",
                         param_dtype=torch.bfloat16,
                         device="cuda") -> Dict[str, Any]:
    """The reference's per-step roofline inputs (flops, bytes, wire and
    operand sums) by its formula (the section's) from two small depths at
    one microbatch and, for train, the shallower at two, on ``ctx``'s
    mesh."""
    t0 = time.time()
    mode = shape_cfg.mode
    La, Lb = _aux_depths(cfg)
    at, _ = count_variants(cfg, shape_cfg, ctx, mb_real,
                           (1, 2) if mode == "train" else (1,), (La, Lb),
                           opt_dtype=opt_dtype, param_dtype=param_dtype,
                           device=device)

    def totals(c):
        return {"flops": c["flops"], "bytes": c["bytes"],
                "wire": sum(v for k, v in c.items()
                            if k.startswith("wire_bytes/")),
                "operand_sum": sum(v for k, v in c.items()
                                   if k.startswith("operand_sum/"))}
    A, B = totals(at[(La, 1)]), totals(at[(Lb, 1)])
    L = cfg.num_layers
    out: Dict[str, Any] = {"L_a": La, "L_b": Lb, "mb_real": mb_real}
    for k in A:
        s = (B[k] - A[k]) / (Lb - La)
        if mode == "train":
            C = totals(at[(La, 2)])
            loss_a = max(C[k] - A[k], 0.0)
            opt = max(A[k] - loss_a, 0.0)
            out[k] = opt + mb_real * (loss_a + (L - La) * s)
        else:
            out[k] = A[k] + (L - La) * s
    out["aux_compile_s"] = round(time.time() - t0, 1)
    return out


# ---------------------------------------------------------------------------
# one step under the recorder
# ---------------------------------------------------------------------------

def _dp_size(view) -> int:
    sizes = axis_sizes(view)
    return math.prod(sizes[n] for n in sizes if n in DP)


def count_step(cfg, shape_cfg, ctx, *, microbatches: int = 1,
               opt_dtype: str = "float32", param_dtype=torch.bfloat16,
               device="cuda", layout_cfg=None) -> Dict[str, Any]:
    """Build the cell's fake params and inputs on ``ctx``'s mesh (none: one
    device) and run its step (``shape_cfg.mode``: the train step, a
    prefill forward, a decode step) once under a :class:`Recorder`, all in
    a ``FakeTensorMode`` (inside ``FakeWorld`` under a mesh).  Returns the
    recorder, the run's seconds and the arguments' and outputs' bytes a
    rank holds.  ``layout_cfg``: see :func:`fake_params`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    # the mesh's rank tensors are real: ops on them stay allowed
    with FakeTensorMode(allow_non_fake_inputs=True):
        return _fake_step(cfg, shape_cfg, ctx, shape_cfg.mode, microbatches,
                          opt_dtype, param_dtype, torch.device(device),
                          layout_cfg)


def _fake_step(cfg, shape_cfg, ctx, mode, microbatches, opt_dtype,
               param_dtype, device, layout_cfg) -> Dict[str, Any]:
    from ..train.optimizer import OptimizerConfig, adamw_init
    view = ctx.mesh
    if view is not None and shape_cfg.global_batch % _dp_size(view):
        # a batch that does not split over dp is replicated, as the
        # reference's input and state specs replicate it (long_500k's 1)
        ctx = _dc.replace(ctx, axes={**ctx.axes, "dp": None})
    params, pshard = fake_params(cfg, view, device, param_dtype, layout_cfg)
    extra = {}
    if mode == "train":
        from ..train.train_step import make_train_step
        opt_cfg = OptimizerConfig(state_dtype=opt_dtype)
        step = make_train_step(cfg, opt_cfg, ctx=ctx,
                               microbatches=microbatches,
                               grad_shardings=pshard)
        opt = adamw_init(params, opt_cfg)
        batch = fake_batch(cfg, shape_cfg, device)
        arg_bytes = _local_bytes(params) + _state_bytes(opt) + \
            _local_bytes(list(batch.values()))

        def fn():
            new_p, new_opt, _, _ = step(params, opt, None, batch)
            return _local_bytes(new_p) + _state_bytes(new_opt)
        extra["opt_state_bytes"] = _state_bytes(opt)
    elif mode == "prefill":
        from ..models.transformer import forward
        from ..parallel.sharding import distribute_local
        batch = fake_batch(cfg, shape_cfg, device)
        arg_bytes = _local_bytes(params) + _local_bytes(list(batch.values()))

        def fn():
            with ctx.scope():
                rows = batch if view is None else {
                    n: distribute_local(x, ctx.dmesh, ctx.placements(
                        "dp", *[None] * (x.dim() - 1)))
                    for n, x in batch.items()}
                rows = dict(rows)
                tokens = rows.pop("tokens")
                logits, _ = forward(params, cfg, tokens, ctx=ctx, **rows)
            return _local_bytes([logits])
    else:
        from ..serve.decode import decode_step
        from ..serve.kv_cache import init_decode_state
        b, s = shape_cfg.global_batch, shape_cfg.seq_len
        state = init_decode_state(cfg, b, s, dtype=torch.bfloat16,
                                  device=device, view=view)
        token = torch.zeros((b, 1), dtype=torch.int32, device=device)
        arg_bytes = _local_bytes(params) + _local_bytes(
            [token, *state.values()])

        def fn():
            logits, _ = decode_step(params, cfg, token, state, ctx=ctx)
            return _local_bytes([logits])
    rec = Recorder(device_type=device.type)
    t0 = time.time()
    with rec:
        out_bytes = fn()
    return {"recorder": rec, "run_s": time.time() - t0,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes, **extra}


# ---------------------------------------------------------------------------
# cell runners
# ---------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "multipod" if multi_pod else "pod"


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               run_overrides: Optional[Dict] = None, *, cfg=None,
               shape_cfg=None, mesh_shape=None, layers: Optional[int] = None,
               device: str = "cuda") -> Dict[str, Any]:
    """One cell's record (the reference's keys; module docstring).
    ``cfg`` / ``shape_cfg`` replace the registered config and shape (a
    reduced config, a small shape), ``mesh_shape`` the production mesh (a
    small mesh, axes ("data", "model") or ("pod", "data", "model")).
    ``layers`` cuts the registered arch in depth (the encoder too), its
    microbatches and remat still the full arch's; the record lists the cut
    under ``reduced``.  ``run_overrides``: RunConfig fields, and
    ``microbatches``, ``opt_state_dtype`` (float32 | bfloat16 | int8),
    ``param_dtype`` (bfloat16 as the reference's, or float32), ``count``
    (auto | full | scaled, :func:`choose_count`; the record's
    ``roofline_count`` says which ran) and ``skip_aux`` (no reference
    extrapolation beside the count; a cell no deeper than the
    extrapolation's second depth has none either)."""
    from .mesh import make_production_mesh, make_smoke_mesh
    full = cfg or get_config(arch)
    cfg = _small_cfg(full, layers) if layers else full
    shape_cfg = shape_cfg or SHAPES[shape_name]
    overrides = dict(run_overrides or {})
    mesh_name = _mesh_name(multi_pod)
    skip = cell_supported(cfg, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": skip}
    dev = check_device(device)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    chips = math.prod(mesh_shape)
    rc_fields = {f.name for f in _dc.fields(RunConfig)}
    merged = {**default_run_overrides(full), **overrides}
    run_cfg = RunConfig(**{k: v for k, v in merged.items()
                           if k in rc_fields and k != "param_dtype"})
    opt_dtype = overrides.get("opt_state_dtype", "float32")
    param_dtype = getattr(torch, overrides.get("param_dtype", "bfloat16"))
    t0 = time.time()
    with FakeWorld(chips):
        if tuple(mesh_shape) in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                        device=dev.type)
        else:
            axes = ("data", "model") if len(mesh_shape) == 2 else (
                "pod", "data", "model")
            mesh = make_smoke_mesh(tuple(mesh_shape), axes, device=dev.type)
        ctx = make_context(mesh, cfg, run_cfg)
        dp = _dp_size(ctx.mesh)
        result: Dict[str, Any] = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "mesh_shape": list(mesh_shape), "chips": chips,
            "device": dev.type, "params_b": cfg.param_count() / 1e9,
            "run_cfg": {"remat": run_cfg.remat,
                        "sequence_parallel": run_cfg.sequence_parallel,
                        "opt_state_dtype": opt_dtype,
                        "param_dtype": str(param_dtype).split(".")[-1]},
        }
        mb = 1
        if shape_cfg.mode == "train":
            mb = overrides.get("microbatches") or default_microbatches(
                full, shape_cfg, dp)
            result["microbatches"] = mb
        if layers:
            result["reduced"] = {"num_layers": [full.num_layers, layers]}
        kind = choose_count(cfg, mb, overrides.get("count", "auto"))
        kw = dict(opt_dtype=opt_dtype, param_dtype=param_dtype,
                  device=dev.type)
        if kind == "full":
            run = count_step(cfg, shape_cfg, ctx, microbatches=mb, **kw)
            counts, run_s = counts_of(run), run["run_s"]
        else:
            depths = _scale_depths(cfg)
            at, run_s = count_variants(cfg, shape_cfg, ctx, mb,
                                       (2, 3) if mb > 2 else (mb,), depths,
                                       **kw)
            counts = scale_counts(at, cfg.num_layers, *depths, mb)
        tokens = shape_cfg.global_batch * (shape_cfg.seq_len if
                                           shape_cfg.mode != "decode" else 1)
        mf = (6 if shape_cfg.mode == "train" else 2) * \
            cfg.active_param_count() * tokens
        coll = stats_of(counts)
        tally = SimpleNamespace(flops=counts["flops"], bytes=counts["bytes"],
                                peak_bytes=counts["temp"])
        result.update(
            status="ok", roofline_count=kind,
            lower_s=round(time.time() - t0 - run_s, 1),
            compile_s=round(run_s, 1), cost=cost_summary(tally),
            memory=memory_summary(tally, counts["argument_bytes"],
                                  counts["output_bytes"]),
            collectives=coll.to_json(), ops=counts["ops"],
            kernel_op_calls={k.split("/", 1)[1]: n for k, n in counts.items()
                             if k.startswith("op_calls/")})
        if shape_cfg.mode == "train":
            result["opt_state_bytes"] = counts["opt_state_bytes"]
        roof = Roofline(hlo_flops=float(counts["flops"]),
                        hbm_bytes=float(counts["bytes"]),
                        wire_bytes=coll.total_wire_bytes, chips=chips,
                        model_flops=mf)
        result["roofline"] = roof.to_json()
        if not overrides.get("skip_aux") and \
                cfg.num_layers > _aux_depths(cfg)[1]:
            failure = Failure()
            with failure:
                result["extrapolation"] = extrapolate_roofline(
                    cfg, shape_cfg, ctx, mb, **kw)
            if failure.error:
                result["aux_error"] = failure.error
    return result


def artifact_path(arch: str, shape: str, mesh: str, tag: str = "",
                  root=None) -> str:
    """The cell's artifact in ``root`` (default ``ARTIFACT_DIR``)."""
    root = Path(root or ARTIFACT_DIR)
    root.mkdir(parents=True, exist_ok=True)
    suffix = f"-{tag}" if tag else ""
    return str(root / f"{arch}--{shape}--{mesh}{suffix}.json")


def run_cell(arch: str, shape: str, multi_pod: bool, force: bool = False,
             tag: str = "", run_overrides: Optional[Dict] = None,
             device: str = "cuda", layers: Optional[int] = None,
             artifact_dir=None) -> Dict:
    """``lower_cell``'s record, written to (or, unless ``force``, read from)
    its artifact; a failure is recorded with status "error"."""
    mesh_name = _mesh_name(multi_pod)
    path = artifact_path(arch, shape, mesh_name, tag, artifact_dir)
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    failure = Failure()
    result = None
    with failure:
        result = lower_cell(arch, shape, multi_pod, run_overrides,
                            layers=layers, device=device)
    if failure.error:
        result = {"arch": arch, "shape": shape, "mesh": mesh_name,
                  "status": "error", "error": failure.error,
                  "traceback": failure.traceback}
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Count every arch x shape x mesh cell at the work one "
                    "device does, on fake tensors and a fake process group "
                    "(no card needed); artifacts in artifacts/dryrun_torch/")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda: the H100 the "
                         "cells model; needs a CUDA build, not a card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each arch to this many layers (recorded "
                         "under 'reduced'; name the artifacts with --tag)")
    ap.add_argument("--artifact-dir", default=None,
                    help="where the artifacts go (default "
                         "artifacts/dryrun_torch/)")
    ap.add_argument("--opt-state-dtype", default=None,
                    choices=["float32", "bfloat16", "int8"],
                    help="AdamW state of the train cells (default float32)")
    args = ap.parse_args(argv)
    overrides = ({"opt_state_dtype": args.opt_state_dtype}
                 if args.opt_state_dtype else None)
    check_device(args.device)

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = (["pod", "multipod"] if args.mesh == "both" else [args.mesh])
    errors = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                r = run_cell(arch, shape, mesh_name == "multipod",
                             force=args.force, tag=args.tag,
                             run_overrides=overrides, device=args.device,
                             layers=args.layers,
                             artifact_dir=args.artifact_dir)
                status = r.get("status")
                extra = ""
                if status == "ok":
                    roof = r["roofline"]
                    extra = (f"run {r['compile_s']}s "
                             f"{r['roofline_count']} dominant="
                             f"{roof['dominant']} "
                             f"tc={roof['t_compute']:.3e} "
                             f"tm={roof['t_memory']:.3e} "
                             f"tx={roof['t_collective']:.3e}")
                elif status == "error":
                    errors += 1
                    extra = r["error"][:160]
                else:
                    extra = r.get("reason", "")[:80]
                print(f"[dryrun] {arch:18s} {shape:12s} {mesh_name:8s} "
                      f"{status:7s} {extra}", flush=True)
    if errors:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
