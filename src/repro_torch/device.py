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
