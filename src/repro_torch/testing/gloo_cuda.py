"""A shim for rank groups that share one card: DTensor's gathers and
reduce-scatters under gloo on CUDA tensors.

Test harness only (``chip_smoke.py`` phase 4h and the rank groups of the
tests); the model and training code never install it, and an NCCL run
needs none of it.  Ranks that share one card cannot form an NCCL
communicator (NCCL refuses two ranks on one device), so they run the
``gloo`` backend on CUDA tensors, which stages each collective through host
memory.  There, on PyTorch 2.11, ``dist.all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single`` and
``broadcast`` all work (``chip_smoke.py`` phase 4h probes them), but the
functional all-gather that DTensor's ``redistribute`` issues
(``_c10d_functional.all_gather_into_tensor``, which calls the process
group's *coalesced* all-gather) crashes the process with a segmentation
fault: a bug of that build's gloo-on-CUDA path.
:func:`use_c10d_collectives` registers CUDA kernels for the functional
all-gather and reduce-scatter ops that call the non-coalesced collectives
above instead: the same collective on the same group, each completed
before it returns (so the ops' ``wait_tensor`` has nothing left to wait
for).  So a run under this shim exercises substituted, synchronous
collectives, not the asynchronous functional ones an NCCL deployment
issues.  It reaches into torch internals (``_resolve_process_group`` and
the ``_c10d_functional`` op names), which may change between versions.
"""

from __future__ import annotations

import torch

_LIB = None


def _reduce_op(name: str):
    import torch.distributed as dist
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}
    if name not in ops:
        raise ValueError(f"gloo reduce-scatter: no reduce op {name!r}")
    return ops[name]


def _all_gather(input, group_size, group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    out = input.new_empty((input.shape[0] * group_size, *input.shape[1:]))
    dist.all_gather_into_tensor(out, input.contiguous(),
                                group=_resolve_process_group(group_name))
    return out


def _reduce_scatter(input, reduce_op, group_size, group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    out = input.new_empty((input.shape[0] // group_size, *input.shape[1:]))
    dist.reduce_scatter_tensor(out, input.contiguous(),
                               op=_reduce_op(reduce_op),
                               group=_resolve_process_group(group_name))
    return out


def use_c10d_collectives() -> None:
    """Route the functional all-gather and reduce-scatter (and their
    coalesced forms) on CUDA tensors through ``dist.all_gather_into_tensor``
    / ``dist.reduce_scatter_tensor``.  Once per process; idempotent."""
    global _LIB
    if _LIB is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _all_gather, "CUDA")
    lib.impl("reduce_scatter_tensor", _reduce_scatter, "CUDA")
    lib.impl("all_gather_into_tensor_coalesced",
             lambda inputs, n, group: [_all_gather(x, n, group)
                                       for x in inputs], "CUDA")
    lib.impl("reduce_scatter_tensor_coalesced",
             lambda inputs, op, n, group: [_reduce_scatter(x, op, n, group)
                                           for x in inputs], "CUDA")
    _LIB = lib
