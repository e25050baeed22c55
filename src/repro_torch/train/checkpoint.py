"""Checkpointing: atomic commits and auto-resume, in the reference's layout
(``repro/train/checkpoint.py``), so that each package restores the other's
checkpoints.

Layout (one directory per step):
    ckpt_dir/step_00000123.tmp/    (written)
    ckpt_dir/step_00000123/        (atomically renamed = committed)
      meta.json                    {"step", "extra"}
      arrays.npz                   one array per leaf

Keys are ``params/<path>`` and, for an ``AdamWState``, ``opt/.step``,
``opt/.m/<path>`` and ``opt/.v/<path>`` (the reference's names for the
namedtuple's fields); an int8 state leaf is two arrays, ``<path>/0`` (int8)
and ``<path>/1`` (float32 scale).  Empty subtrees have no array.  A bf16
leaf is written as float32, which holds it exactly and which the reference
restores into bf16; a reference bf16 array (``ml_dtypes``, read back by
numpy as raw 2-byte void) is restored from its bits.  ``latest_step``
skips torn ``.tmp`` directories.

Under a mesh (DTensor leaves) every rank calls ``save``: each leaf is
gathered in turn and rank 0 alone writes and commits, then the ranks meet
at a barrier, so the files are the unsharded layout that restores with no
mesh, on another mesh, or in the reference.  An int8 state leaf under a
mesh (q (*lead, blocks, 128), ``train/optimizer.py``) is written in the
reference's (rows, blocks, 128) / (rows, blocks, 1).  ``restore(...,
shardings=)`` lays each leaf out on the current mesh as it is read (the
reference's elastic path; an int8 leaf in ``optimizer.int8_layout``'s
placements); a DTensor template is restored in its own layout.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import is_dtensor
from .optimizer import AdamWState
from .tree import Tree, flatten, leaves, unflatten


def _arrays(tree: Tree, prefix: str, keep: bool = True
            ) -> Dict[str, np.ndarray]:
    """One array per leaf; a DTensor leaf is gathered first (every rank
    takes part), and only a rank that ``keep``s them holds the arrays."""
    out = {}
    for path, leaf in flatten(tree):
        parts = leaf if isinstance(leaf, tuple) else (leaf,)
        for i, part in enumerate(parts):
            if is_dtensor(part):
                part = part.full_tensor()
            if not keep:
                continue
            t = part.detach().cpu()
            if isinstance(leaf, tuple):     # int8 (q, scale): (rows, b, *)
                t = t.reshape(-1, *t.shape[-2:])
            key = f"{prefix}/{path}" + (f"/{i}" if isinstance(leaf, tuple)
                                        else "")
            out[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _opt_arrays(opt: AdamWState, keep: bool = True
                ) -> Dict[str, np.ndarray]:
    out = {"opt/.step": opt.step.detach().cpu().numpy()}
    out.update(_arrays(opt.m, "opt/.m", keep))
    out.update(_arrays(opt.v, "opt/.v", keep))
    return out


def save(ckpt_dir: str, step: int, params: Tree,
         opt_state: Optional[AdamWState] = None,
         extra: Optional[Dict] = None) -> str:
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    sharded = any(is_dtensor(x) for x in leaves(params))
    writer = not sharded or dist.get_rank() == 0
    arrays = _arrays(params, "params", writer)
    if opt_state is not None:
        arrays.update(_opt_arrays(opt_state, writer))
    if not writer:
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "extra": extra or {}}, f)
    os.rename(tmp, final)  # atomic commit
    if sharded:
        dist.barrier()
    return final


def _committed_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _tensor(arr: np.ndarray, like: torch.Tensor, key: str,
            sharding=None) -> torch.Tensor:
    """``arr`` in ``like``'s dtype: on ``sharding``'s mesh in its layout,
    else in a DTensor ``like``'s layout, else on ``like``'s device."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: ckpt {arr.shape} vs template "
                         f"{tuple(like.shape)}")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # ml_dtypes bf16
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if sharding is None and is_dtensor(like):
        sharding = like
    if sharding is not None:          # a NamedSharding, or a DTensor
        from ..parallel.sharding import distribute_local
        return distribute_local(t.to(like.dtype), sharding.device_mesh,
                                sharding.placements)
    return t.to(device=like.device, dtype=like.dtype)


def _int8_part(arr: np.ndarray, like: torch.Tensor, key: str, i: int,
               sharding=None, shape=None) -> torch.Tensor:
    """Part ``i`` (q or scale) of an int8 state leaf, read in the
    reference's (rows, blocks, *): laid out on ``sharding``'s mesh (the
    param's; ``shape`` the param's global shape) in the state's layout, or
    in a DTensor ``like``'s, or as ``like`` is."""
    from ..parallel.sharding import distribute_local
    from .optimizer import int8_layout, int8_shapes
    if sharding is None and not is_dtensor(like):
        return _tensor(arr, like, key)
    if sharding is not None:
        mesh = sharding.device_mesh
        target = int8_shapes(shape)[i]
        placements = int8_layout(shape, mesh, sharding.placements)
    else:
        mesh, target, placements = (like.device_mesh, tuple(like.shape),
                                    like.placements)
    if arr.size != np.prod(target):
        raise ValueError(f"{key}: ckpt {arr.shape} vs the state's {target}")
    t = torch.from_numpy(np.array(arr)).reshape(target).to(like.dtype)
    return distribute_local(t, mesh, placements)


def _rebuild(data, template: Tree, prefix: str, shardings=None,
             params=None) -> Tree:
    out = []
    where = (dict(flatten(shardings)) if shardings is not None else {})
    shapes = {p: tuple(x.shape) for p, x in flatten(params)} if params \
        is not None else {}
    for path, leaf in flatten(template):
        key = f"{prefix}/{path}"
        if isinstance(leaf, tuple):
            out.append(tuple(
                _int8_part(data[f"{key}/{i}"], part, f"{key}/{i}", i,
                           where.get(path), shapes.get(path))
                for i, part in enumerate(leaf)))
        else:
            out.append(_tensor(data[key], leaf, key, where.get(path)))
    return unflatten(template, out)


def restore(ckpt_dir: str, step: int, params_template: Tree,
            opt_template: Optional[AdamWState] = None, shardings=None
            ) -> Tuple[Tree, Optional[AdamWState], Dict]:
    """Restore onto the templates' trees, dtypes and devices.
    ``shardings`` (a tree of ``parallel.sharding.NamedSharding`` like the
    params, ``launch.dryrun.sharded_param_specs``) lays each param leaf and
    its AdamW moments out on the current mesh: the elastic path, save on
    mesh A, restore on mesh B.  Every rank reads the files."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        params = _rebuild(data, params_template, "params", shardings)
        opt = None
        if opt_template is not None:
            opt = AdamWState(
                _tensor(data["opt/.step"], opt_template.step, "opt/.step"),
                _rebuild(data, opt_template.m, "opt/.m", shardings,
                         params_template),
                _rebuild(data, opt_template.v, "opt/.v", shardings,
                         params_template))
    return params, opt, meta


def restore_latest(ckpt_dir: str, params_template: Tree,
                   opt_template: Optional[AdamWState] = None, shardings=None
                   ) -> Optional[Tuple[int, Tree, Any, Dict]]:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    params, opt, meta = restore(ckpt_dir, step, params_template,
                                opt_template, shardings)
    return step, params, opt, meta


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    steps = _committed_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
