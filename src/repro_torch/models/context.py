"""ModelContext: the distribution context threaded through model code.

The port runs on one device so far: ``shard`` is the identity.  Model code
still calls it at the reference's sharding points, which is where the
multi-GPU slice will place its collectives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelContext:
    ssm_chunk: int = 16     # chunk of the RWKV6 recurrence (cut by _fit_chunk)

    def shard(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        return x


NULL_CTX = ModelContext()
