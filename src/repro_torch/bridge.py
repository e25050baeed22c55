"""Parameters between the reference's layout and the port's.

The reference's param pytree, as ``jax.tree_util.tree_map(np.asarray,
repro.models.transformer.init_lm(...))`` gives it, is nested dicts of numpy
arrays.  The port keeps the same keys and shapes (``embed``, ``ln_f/scale``,
``lm_head``; dense ``layers/{ln1,ln2,attn/{wq,wk,wv,wo},mlp/{w_up,w_gate,
w_down}}``; ssm ``layers/{ln1,ln2,tmix/{w_r,w_k,w_v,w_g,w_o,w_decay_a,
w_decay_b,decay_base,bonus_u,mix_x,ln_x},cmix/{w_k,w_v,mix}}``; stacked ``L``
axis, ``(d_in, d_out)`` matrices) as nested dicts of tensors, so both
packages compute the same function on the same numbers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import resolve_device


def params_from_numpy(tree: Dict[str, Any], *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (cast to ``dtype`` when given)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, copy=True))
        return t.to(device=dev, dtype=dtype or t.dtype)
    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays (bf16 leaves
    come back as float32, which holds them exactly)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return conv(params)
