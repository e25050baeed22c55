"""Parameters between the reference's layout and the port's.

The reference's param pytree, as ``jax.tree_util.tree_map(np.asarray,
repro.models.transformer.init_lm(...))`` gives it, is nested dicts of numpy
arrays.  The port keeps the same keys and shapes (``embed``, ``ln_f/scale``,
``lm_head``; dense ``layers/{ln1,ln2,attn/{wq,wk,wv,wo},mlp/{w_up,w_gate,
w_down}}``; ssm ``layers/{ln1,ln2,tmix/{w_r,w_k,w_v,w_g,w_o,w_decay_a,
w_decay_b,decay_base,bonus_u,mix_x,ln_x},cmix/{w_k,w_v,mix}}``; moe
``layers/moe/...`` and ``dense_layers``; hybrid ``layers/{ln,mamba/{w_in,
w_bc,w_dt,a_log,d_skip,dt_bias,conv,w_out,norm}}`` with the unstacked
``shared_block`` (a dense layer) and ``shared_proj``; audio (enc-dec) the
dense decoder ``layers`` plus ``encoder_layers`` (dense layers), the
decoder's stacked ``cross_attn/{ln,attn}`` and ``ln_enc``; vlm the dense
``layers`` plus the unstacked ``patch_proj`` (d_model, d_model); stacked
``L`` axis, ``(d_in, d_out)`` matrices) as nested dicts of tensors, so both
packages compute the same function on the same numbers.

Optimizer state crosses the same way: the reference's ``AdamWState(step,
m, v)`` as numpy (``jax.tree_util.tree_map(np.asarray, state)``; an int8
leaf is a (q, scale) tuple, a bf16 leaf an ``ml_dtypes`` array) becomes the
port's ``train.optimizer.AdamWState`` and back, so both packages take one
update from the same state.  Under a mesh (``params=`` DTensors) a state
leaf is laid out as its param's state (an int8 leaf's q (*lead, blocks,
128) in ``optimizer.int8_layout``'s placements), and a sharded state comes
back gathered, int8 leaves in the reference's (rows, blocks, 128).  The
error-feedback state is a float32 tree like the params and crosses with
``params_from_numpy`` / ``params_to_numpy``.

Under a mesh, ``place_params`` lays a bridged (or port-initialised) tree
out by ``launch.dryrun.sharded_param_specs``, leaf by leaf: each rank keeps
its shard of one leaf before it takes the next.  ``init_sharded`` draws
``init_lm``'s tree straight into the shards: one rank at a time draws each
matrix on the card, keeps its shard and frees the rest before the next is
drawn, so that no two full matrices are alive at once on a shared card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import is_dtensor, resolve_device
from .train.optimizer import AdamWState
from .train.tree import flatten, get_path, tree_map_with_path


def _from_numpy(x, dev, dtype=None):
    if isinstance(x, dict):
        return {k: _from_numpy(v, dev, dtype) for k, v in x.items()}
    if isinstance(x, tuple):                  # int8 state leaf: (q, scale)
        return tuple(_from_numpy(p, dev, dtype) for p in x)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":            # ml_dtypes, exact in float32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=dev, dtype=dtype or t.dtype)


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):              # int8 (q, scale): (rows, b, *)
        return tuple(_to_numpy(p).reshape(-1, *p.shape[-2:]) for p in x)
    if is_dtensor(x):
        x = x.full_tensor()
    t = x.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_numpy(tree: Dict[str, Any], *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (cast to ``dtype`` when given)."""
    return _from_numpy(tree, resolve_device(device), dtype)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays (bf16 leaves
    come back as float32, which holds them exactly)."""
    return _to_numpy(params)


def opt_state_from_numpy(state, *, device="cuda",
                         params=None) -> AdamWState:
    """The reference's ``AdamWState`` as numpy -> the port's on ``device``,
    every leaf in its dtype (float32, bf16, or int8 q with float32
    scale); with ``params`` (DTensors, every rank the same ``state``) laid
    out as each param's state on its mesh."""
    dev = resolve_device(device)
    out = AdamWState(*(_from_numpy(x, dev) for x in state))
    if params is None:
        return out
    from .parallel.sharding import distribute_local
    from .train.optimizer import int8_layout, int8_shapes

    def place(path, leaf):
        p = get_path(params, path)
        if not isinstance(leaf, tuple):
            return _place(leaf, p)
        mesh = p.device_mesh
        pl = int8_layout(p.shape, mesh, p.placements)
        return tuple(distribute_local(part.reshape(shape), mesh, pl)
                     for part, shape in zip(leaf, int8_shapes(p.shape)))
    return AdamWState(out.step, tree_map_with_path(place, out.m),
                      tree_map_with_path(place, out.v))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """The port's ``AdamWState`` -> numpy leaves in the same tree (bf16
    leaves come back as float32, which holds them exactly; DTensor leaves
    gathered, every rank taking part)."""
    return AdamWState(*(_to_numpy(x) for x in state))


# ---------------------------------------------------------------------------
# trees on a mesh
# ---------------------------------------------------------------------------

def _place(leaf, sharding):
    from .parallel.sharding import distribute_local
    return distribute_local(leaf, sharding.device_mesh, sharding.placements)


def place_params(params: Dict[str, Any], cfg, view) -> Dict[str, Any]:
    """``params`` (the same full tree on every rank of ``view``) as DTensors
    laid out by ``sharded_param_specs``, leaf by leaf."""
    from .launch.dryrun import sharded_param_specs
    shardings = sharded_param_specs(params, cfg, view)
    return tree_map_with_path(
        lambda path, leaf: _place(leaf, get_path(shardings, path)), params)


def init_sharded(cfg, view, seed: int = 0, *,
                 dtype=torch.float32) -> Dict[str, Any]:
    """``init_lm(cfg, seed, dtype=dtype)``'s tree as DTensors laid out by
    ``sharded_param_specs`` on ``view``, drawn on the mesh's device.  The
    ranks take turns (a barrier of the default group between them): a
    rank draws the matrices in order, keeping its shard of each as it is
    drawn (``init_lm(place=)``), then frees its cache for the next rank.
    The values equal ``place_params(init_lm(...))``'s."""
    import torch.distributed as dist

    from .launch.dryrun import sharded_param_specs
    from .models.transformer import init_lm
    order = []
    abstract = init_lm(cfg, device="meta", dtype=dtype,
                       place=lambda w: order.append(w) or w)
    path_of = {id(leaf): path for path, leaf in flatten(abstract)}
    paths = iter([path_of[id(w)] for w in order])
    del order
    shardings = sharded_param_specs(abstract, cfg, view)

    def place(w):
        return _place(w, get_path(shardings, next(paths)))

    dev = resolve_device(view.device_type)
    tree = None
    for turn in range(dist.get_world_size()):
        dist.barrier()
        if dist.get_rank() == turn:
            tree = init_lm(cfg, seed, device=dev, dtype=dtype, place=place)
            tree = tree_map_with_path(
                lambda path, leaf: leaf if is_dtensor(leaf) else
                _place(leaf, get_path(shardings, path)), tree)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
    dist.barrier()
    return tree
