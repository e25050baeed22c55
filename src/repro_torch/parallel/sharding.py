"""Sharding rules: mesh views, parameter specs, input specs.

The port of ``repro/parallel/sharding.py``.  The production mesh is fixed,
``(data=16, model=16)`` per pod with a pure-DP ``pod`` axis in front
(``launch/mesh.py``).  Architectures map onto it through a *mesh view*: the
16-way ``model`` axis is reshaped into two factors ``("a", "b")`` chosen per
arch so that every sharded dimension divides evenly:

  dense      a = largest divisor of num_heads dividing 16 (heads over "a");
             d_ff / vocab shard over ("a", "b") jointly
  moe        a = EP degree (experts over "a"), b = expert-internal TP
  ssm/hybrid a·b split chosen for rwkv heads / mamba d_inner

Logical-axis table (read by ``ModelContext.shard``):
  dp -> ("pod", "data")   tp -> ("a", "b")   tp_a -> "a"   tp_b -> "b"
  sp -> ("a", "b") when sequence_parallel (activation seq dim between blocks)

A spec is what the reference's ``PartitionSpec`` is: one entry per tensor
dim, each ``None``, a mesh axis name, or a tuple of names (major first).
:class:`P` is that tuple; :func:`spec_placements` turns one into DTensor
placements on a ``DeviceMesh``: ``Shard(d)`` on each mesh dim that entry
``d`` names, ``Replicate()`` on the others.  The rules match on the
parameter's path, as the reference's do, so the whole spec table compares
with the reference's without a process group.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.context import ModelContext
from ..train.tree import tree_map_with_path

DP = ("pod", "data")


class P(tuple):
    """A partition spec: ``P(None, ("a", "b"))`` as the reference writes
    ``PartitionSpec(None, ("a", "b"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def axis_sizes(view) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any view whose
    ``shape`` maps names to sizes (the reference's ``Mesh.shape``)."""
    names = getattr(view, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, view.mesh.shape))
    return dict(view.shape)


def compute_mesh(view):
    """The mesh DTensors live on: ``view`` without its axes of size 1 (they
    shard nothing, and every extra mesh dim multiplies the layouts DTensor
    weighs for each op), or its first axis where all are of size 1."""
    names = view.mesh_dim_names
    keep = tuple(n for n, k in zip(names, view.mesh.shape) if k > 1)
    if keep == tuple(names):
        return view
    return view[keep or names[:1]]


def spec_placements(spec, mesh) -> List:
    """DTensor placements of ``spec`` on ``compute_mesh(mesh)``: mesh dim
    ``i`` gets ``Shard(d)`` where entry ``d`` names it, else
    ``Replicate()``; axes of size 1 shard nothing and are left out.  A
    tuple entry must list its axes in the mesh's order (the reference's
    major-to-minor split), which is DTensor's order for two shards of one
    dim."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    names = list(compute_mesh(mesh).mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a not in sizes for a in axes):
            raise ValueError(f"spec {spec}: axes {axes} are not all in the "
                             f"mesh's {tuple(sizes)}")
        idx = [names.index(a) for a in axes if sizes[a] > 1]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def shard_block(mesh, dims) -> int:
    """This rank's block of a tensor dim split over mesh ``dims`` (in the
    mesh's order, as DTensor splits it: the first dim's chunks, then each
    cut by the next)."""
    coord, block = mesh.get_coordinate(), 0
    for i in dims:
        block = block * mesh.size(i) + coord[i]
    return block


def distribute_local(full: torch.Tensor, mesh, placements):
    """The DTensor of ``full`` (the same on every rank) laid out as
    ``placements`` on ``mesh``: each rank copies out its own shard onto the
    mesh's device, with no collective, so ``full`` can be freed at once.
    Every split must be even, as the sanitized specs make them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..device import resolve_device
    coord = mesh.get_coordinate()
    local = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not split evenly {n} ways")
            local = local.chunk(n, dim=p.dim)[coord[i]]
        elif not isinstance(p, Replicate):
            raise ValueError(f"distribute_local: cannot lay out as {p}")
    out = torch.empty(local.shape, dtype=local.dtype,
                      device=resolve_device(mesh.device_type))
    out.copy_(local)
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``NamedSharding``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> List:
        """On :attr:`device_mesh`."""
        return spec_placements(self.spec, self.mesh)

    @property
    def device_mesh(self):
        """The mesh the DTensor lives on (``compute_mesh``)."""
        return compute_mesh(self.mesh)


def _largest_divisor_leq(n: int, cap: int) -> int:
    best = 1
    for d in range(1, cap + 1):
        if n % d == 0 and cap % d == 0:
            best = d
    return best


def choose_view_factors(cfg, model_axis: int) -> Tuple[int, int]:
    """(a, b) with a·b = model_axis, per family (see module docstring)."""
    if cfg.family == "moe":
        a = _largest_divisor_leq(cfg.moe_num_experts, model_axis)
        return a, model_axis // a
    heads = cfg.num_heads if cfg.family != "ssm" else (
        cfg.d_model // cfg.rwkv_head_dim)
    a = _largest_divisor_leq(heads, model_axis)
    return a, model_axis // a


def mesh_view(mesh, cfg) -> Tuple[Any, Dict[str, Any]]:
    """Reshape the mesh's last (model) axis into ("a", "b"): a new
    ``DeviceMesh`` over the same ranks in the same order.  Every rank of
    the mesh must call it, in the same order (it makes process groups)."""
    from torch.distributed.device_mesh import DeviceMesh
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(mesh.mesh.shape)
    a, b = choose_view_factors(cfg, shape[-1])
    new_names = names[:-1] + ("a", "b")
    view = DeviceMesh(mesh.device_type, mesh.mesh.reshape(shape[:-1] + (a, b)),
                      mesh_dim_names=new_names)
    dp = tuple(n for n in new_names if n in DP)
    axes = {"dp": dp if len(dp) > 1 else dp[0], "tp": ("a", "b"),
            "tp_a": "a", "tp_b": "b"}
    return view, axes


def make_context(mesh, cfg, run_cfg=None) -> ModelContext:
    if mesh is None:
        return ModelContext()
    view, axes = mesh_view(mesh, cfg)
    sp = bool(run_cfg and run_cfg.sequence_parallel)
    if sp:
        axes = dict(axes, sp=("a", "b"))
    return ModelContext(
        mesh=view, axes=axes,
        ep_axis="a" if cfg.family == "moe" else None,
        ep_tp_axis=("b" if (cfg.family == "moe"
                            and axis_sizes(view)["b"] > 1) else None),
        remat=(run_cfg.remat if run_cfg else "none"),
        sequence_parallel=sp,
        ssm_chunk=(run_cfg.ssm_chunk if run_cfg else 128),
    )


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

# (path regex, spec) — first match wins.  A leading layer-stack axis is
# added for leaves under layers/dense_layers/encoder_layers/cross_attn.
_STACKED = re.compile(
    r"(layers|dense_layers|encoder_layers|cross_attn)($|/)")


def _rules(cfg):
    tp = ("a", "b")
    return [
        # embeddings / head: vocab over tp
        (r"embed$",            P(tp, None)),
        (r"lm_head$",          P(None, tp)),
        (r"patch_proj$",       P(None, tp)),
        # attention: fused head dim over tp
        (r"attn/w[qkv]$",      P(None, tp)),
        (r"attn/wo$",          P(tp, None)),
        (r"attn/b[qkv]$",      P(tp)),
        # dense mlp
        (r"mlp/w_(up|gate)$",  P(None, tp)),
        (r"mlp/w_down$",       P(tp, None)),
        # moe experts: E over "a", F over "b"
        (r"moe/w_(up|gate)$",  P("a", None, "b")),
        (r"moe/w_down$",       P("a", "b", None)),
        (r"moe/router$",       P(None, None)),
        (r"moe/shared/w_(up|gate)$", P(None, "b")),
        (r"moe/shared/w_down$",      P("b", None)),
        # rwkv time-mix / channel-mix
        (r"tmix/w_[rkvgo]$",   P(None, tp)),
        (r"tmix/w_decay_a$",   P(None, None)),
        (r"tmix/w_decay_b$",   P(None, tp)),
        (r"cmix/w_k$",         P(None, tp)),
        (r"cmix/w_v$",         P(tp, None)),
        # mamba2
        (r"mamba/w_in$",       P(None, tp)),
        (r"mamba/w_out$",      P(tp, None)),
        (r"mamba/w_bc$",       P(None, None)),
        (r"mamba/w_dt$",       P(None, None)),
        (r"mamba/conv$",       P(None, tp)),
        (r"mamba/norm/scale$", P(tp)),
        (r"shared_proj$",      P(None, tp)),
        # everything else (norms, scalars): replicated
        (r".*",                P()),
    ]


def _path_str(path) -> str:
    """A leaf's path: a "/"-joined string (the port's trees are nested
    dicts, so ``train.tree.flatten`` gives it), or a sequence of keys."""
    return path if isinstance(path, str) else "/".join(str(p) for p in path)


def param_spec(path, leaf, cfg) -> P:
    s = _path_str(path)
    stacked = bool(_STACKED.search(s))
    for pat, spec in _rules(cfg):
        if re.search(pat, s):
            # hybrid shared_block params match the attn / mlp rules; the
            # zamba shared block is not stacked
            if stacked:
                if len(spec) + 1 > leaf.ndim:
                    return P()  # scalar-ish leaf; replicate
                return P(None, *spec)
            if len(spec) > leaf.ndim:
                return P()
            return spec
    return P()


def sanitize_spec(spec: P, leaf, view) -> P:
    """Drop or reduce sharding axes that do not divide a dimension evenly.

    Tuple entries shrink from the right (("a","b") → ("a",) → None) so the
    largest feasible factor is kept: whisper's vocab 51865 has no
    power-of-two factor and falls back to replication, while 40-head archs
    keep the 8-way "a" factor of the 16-way model axis."""
    sizes = axis_sizes(view)
    entries = []
    for d in range(len(spec)):
        ax = spec[d]
        if ax is None:
            entries.append(None)
            continue
        axes = list(ax) if isinstance(ax, tuple) else [ax]
        while axes:
            if leaf.shape[d] % math.prod(sizes[a] for a in axes) == 0:
                break
            axes.pop()
        entries.append(tuple(axes) if len(axes) > 1 else
                       (axes[0] if axes else None))
    return P(*entries)


def param_shardings(params, cfg, mesh_or_view) -> Any:
    """:class:`NamedSharding` tree for the parameter tree."""
    view = mesh_or_view
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            view, sanitize_spec(param_spec(path, leaf, cfg), leaf, view)),
        params)


def abstract_params(cfg, dtype=torch.float32):
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    allocation (the reference's ``eval_shape`` of ``init_lm``)."""
    from ..models.transformer import init_lm
    return init_lm(cfg, device="meta", dtype=dtype)


# ---------------------------------------------------------------------------
# input specs (meta tensors, shardable, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape_cfg, view=None) -> Dict[str, Any]:
    """Model inputs for one (arch × shape) cell as meta tensors.

    train/prefill: tokens + labels (B, S); decode: one token (the decode
    state is built separately)."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    out: Dict[str, Any] = {}
    if shape_cfg.mode in ("train", "prefill"):
        out["tokens"] = _meta((b, s), torch.int32)
        if shape_cfg.mode == "train":
            out["labels"] = _meta((b, s), torch.int32)
        if cfg.frontend == "patch":
            out["patch_embeds"] = _meta((b, cfg.num_patches, cfg.d_model),
                                        torch.bfloat16)
        if cfg.frontend == "frames":
            out["frame_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    else:  # decode: one new token against a cache of length s
        out["tokens"] = _meta((b, 1), torch.int32)
    return out


def input_shardings(cfg, shape_cfg, view) -> Dict[str, Any]:
    sizes = axis_sizes(view)
    dp = tuple(n for n in sizes if n in DP)
    dp_axes = dp if len(dp) > 1 else dp[0]
    b = shape_cfg.global_batch
    dp_size = math.prod(sizes[n] for n in dp)
    batch_spec = dp_axes if b % dp_size == 0 else None  # tiny-batch decode
    out = {"tokens": NamedSharding(view, P(batch_spec, None))}
    if shape_cfg.mode == "train":
        out["labels"] = NamedSharding(view, P(batch_spec, None))
    if shape_cfg.mode in ("train", "prefill"):
        if cfg.frontend == "patch":
            out["patch_embeds"] = NamedSharding(view,
                                                P(batch_spec, None, None))
        if cfg.frontend == "frames":
            out["frame_embeds"] = NamedSharding(view,
                                                P(batch_spec, None, None))
    return out
