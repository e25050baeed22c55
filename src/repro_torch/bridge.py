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
update from the same state.  The error-feedback state is a float32 tree
like the params and crosses with ``params_from_numpy`` /
``params_to_numpy``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .train.optimizer import AdamWState


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
    if isinstance(x, tuple):
        return tuple(_to_numpy(p) for p in x)
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


def opt_state_from_numpy(state, *, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` as numpy -> the port's on ``device``,
    every leaf in its dtype (float32, bf16, or int8 q with float32
    scale)."""
    dev = resolve_device(device)
    return AdamWState(*(_from_numpy(x, dev) for x in state))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """The port's ``AdamWState`` -> numpy leaves in the same tree (bf16
    leaves come back as float32, which holds them exactly)."""
    return AdamWState(*(_to_numpy(x) for x in state))
