"""Test-support utilities (deterministic fault injection, rank groups).

Nothing in here runs in production paths unless explicitly armed via
environment variables — see :mod:`repro_torch.testing.chaos`.
"""

from .chaos import (ChaosError, ChaosRule, TransientChaosError, chaos_hook,
                    chaos_rules, parse_chaos)
from .ranks import RankGroupError, run_ranks

__all__ = [
    "ChaosError",
    "ChaosRule",
    "TransientChaosError",
    "chaos_hook",
    "chaos_rules",
    "parse_chaos",
    "RankGroupError",
    "run_ranks",
]
