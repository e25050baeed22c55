"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Where no
card is present and none was asked for, they raise: the port never falls
back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev


def is_dtensor(x) -> bool:
    """A DTensor: a shard of a tensor laid out over a ``DeviceMesh``."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
