"""Test-support utilities (deterministic fault injection, etc.).

Nothing in here runs in production paths unless explicitly armed via
environment variables — see :mod:`repro_torch.testing.chaos`.
"""

from .chaos import (ChaosError, ChaosRule, TransientChaosError, chaos_hook,
                    chaos_rules, parse_chaos)

__all__ = [
    "ChaosError",
    "ChaosRule",
    "TransientChaosError",
    "chaos_hook",
    "chaos_rules",
    "parse_chaos",
]
