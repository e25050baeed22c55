"""Unified simulation configuration (:class:`SimConfig`).

One frozen dataclass replaces the kwarg sprawl that used to be threaded
separately through ``ClusterSimulator``, ``simulate()``, ``run_campaign()``
and the ``sweep campaign`` CLI.  Every legacy loose-kwarg call site keeps
working — the entry points build a ``SimConfig`` behind the scenes — so a
config object and the equivalent kwargs produce bit-identical schedules
(``tests/test_strategies.py::test_simconfig_matches_legacy_kwargs``).

Validation happens at construction: strategy names resolve against the
live plugin registry (:mod:`repro_torch.core.strategies`), so error messages
enumerate runtime-registered strategies too.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from .events import ClusterEvent
from .scheduler import QUEUE_POLICIES
from .strategies import Strategy, get_strategy

#: simulator engines — ``v1`` scan engine, ``v2`` heap engine (default),
#: ``batched`` lane engine (flat-array lockstep runner, falls back to v2
#: for non-qualifying configs); bit-identical schedules (see
#: docs/simulator.md and docs/batched.md)
ENGINES = ("v1", "v2", "batched")
#: campaign per-cell sample stores — keep everything vs condense to
#: bounded-size order statistics
STORES = ("full", "stream")


@dataclass(frozen=True)
class SimConfig:
    """Everything about *how* to simulate, minus the cluster and the jobs.

    ``strategy`` may be a registered name or a :class:`Strategy` instance
    (handy for unregistered test doubles; campaigns require names so
    worker processes can resolve them).  ``workers`` / ``store`` only
    apply to campaigns; single runs ignore them.
    """

    strategy: Union[str, Strategy] = "vclos"
    scheduler: str = "fifo"
    seed: int = 0
    ilp_time_limit: float = 2.0
    incremental: bool = True
    engine: str = "v2"
    max_time: float = math.inf
    # dynamic-events knobs (repro_torch.core.events): the event trace applied to
    # this run, the migration-defrag tick period (0 = off; ticks sample the
    # fragmentation index for every strategy, migrations only happen for
    # strategies with Strategy.supports_migration), and the checkpoint
    # -restart cost of one migration in iterations
    events: Tuple[ClusterEvent, ...] = ()
    defrag_interval: float = 0.0
    migration_iters: float = 25.0
    # campaign-only knobs
    workers: Optional[int] = None
    store: str = "full"
    # trace-ingestion knob (repro_torch.core.traces): which schema adapter reads
    # an external --trace file — "auto" sniffs the header, or a registered
    # adapter name ("csv", "alibaba", "generic"); synthetic workloads
    # ignore it
    trace_format: str = "auto"
    # fault-policy knobs (repro_torch.core.runtime): per-cell wall-clock timeout
    # in seconds (0 disables; > 0 requires pool execution, so it forces the
    # worker-pool path even at workers=1), extra attempts granted to
    # retryable failures (crash / timeout / transient exception), base of
    # the exponential retry backoff in seconds, and whether permanently
    # failed cells are quarantined into CampaignResult.failed_cells instead
    # of aborting the campaign with CampaignError
    cell_timeout: float = 0.0
    max_retries: int = 2
    retry_backoff: float = 0.05
    quarantine: bool = False

    def __post_init__(self) -> None:
        get_strategy(self.strategy)   # raises listing registered names
        if self.scheduler not in QUEUE_POLICIES:
            raise ValueError(f"unknown queueing policy {self.scheduler!r}; "
                             f"choose from {QUEUE_POLICIES}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"choose from {ENGINES}")
        if self.store not in STORES:
            raise ValueError(f"unknown store mode {self.store!r}; "
                             f"choose 'full' or 'stream'")
        if self.trace_format != "auto":
            # the port has no trace adapters yet (they come with the traces
            # slice), so no named format can be read
            raise ValueError(
                f"unknown trace format {self.trace_format!r}; the port "
                f"reads no external traces yet, choose 'auto'")
        for ev in self.events:
            if not isinstance(ev, ClusterEvent):
                raise TypeError(f"SimConfig.events needs ClusterEvent "
                                f"entries, got {ev!r}")
        if self.defrag_interval < 0:
            raise ValueError("defrag_interval must be >= 0 (0 disables)")
        if self.migration_iters < 0:
            raise ValueError("migration_iters must be >= 0")
        if self.cell_timeout < 0:
            raise ValueError("cell_timeout must be >= 0 (0 disables; "
                             "> 0 runs cells under a worker pool so hung "
                             "cells can be killed)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0 (0 means one "
                             "attempt, no retries)")
        if self.retry_backoff < 0:
            raise ValueError("retry_backoff must be >= 0 (0 retries "
                             "immediately)")

    def resolve_strategy(self) -> Strategy:
        """The registry instance behind :attr:`strategy`."""
        return get_strategy(self.strategy)

    def with_overrides(self, **overrides) -> "SimConfig":
        """A copy with every non-``None`` override applied — the shared
        precedence rule of the entry points: explicit loose kwargs passed
        *alongside* a config override that config's fields; omitted ones
        (``None``) keep the config's values."""
        kept = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **kept) if kept else self
