"""Pluggable scheduling strategies — the registry every scenario hangs off.

A *strategy* bundles everything the simulator (and the online scheduler
facade) needs to know about one scheduling scenario:

  * a **routing factory** (:meth:`Strategy.make_routing`) — how flows map
    onto fabric links,
  * a **placement function** (:meth:`Strategy.place`) — which GPUs a job
    gets, plus any link reservations / OCS rewiring,
  * **isolation semantics** (:attr:`Strategy.isolated`) — whether link
    reservation pins every bandwidth share at 1, letting the engines skip
    link accounting entirely,
  * **OCS hooks** (:attr:`Strategy.requires_ocs`,
    :attr:`Strategy.wants_ocs_spec`) — whether the strategy needs an
    optical-circuit layer and whether campaigns should hand it the
    ``*_OCS`` cluster preset,
  * a **failure-memoisation policy** (:attr:`Strategy.memoize_failures`) —
    whether a failed placement is a pure function of fabric state (the v2
    engine then caches it against the state version),
  * **queue-policy compatibility** (:attr:`Strategy.queue_policies`).

Strategies register under a unique name via :func:`register_strategy` and
are resolved by :func:`get_strategy`; ``ClusterSimulator`` holds no
per-strategy ``if`` chains — everything dispatches through the instance
looked up here.  The seven paper strategies live in
:mod:`repro_torch.core.strategies.builtin`; ``contention-affinity``
(:mod:`repro_torch.core.strategies.contention_affinity`) is registered purely
through this public API and doubles as the worked example for external
plugins (see ``docs/strategies.md``).

The placement context
---------------------

``place`` receives a *context* object rather than the simulator class, so
plugins stay decoupled from engine internals.  The contract (duck-typed —
any object with these members works, including hand-rolled test doubles):

  * ``ctx.spec`` — the :class:`repro_torch.core.topology.ClusterSpec`
  * ``ctx.state`` — the live :class:`repro_torch.core.topology.FabricState`
  * ``ctx.seed`` — the run's RNG seed (per-job randomness derives from it)
  * ``ctx.ilp_time_limit`` — wall-clock budget for MILP fallbacks

Simulator contexts additionally expose the current traffic picture for
contention-aware placements:

  * ``ctx.dense_link_load()`` — per-link running flow counts, a read-only
    int64 vector over :class:`repro_torch.core.routing.LinkSpace` ids
  * ``ctx.leaf_link_load()`` — that load folded to one int64 per leaf
    (uplinks + downlinks touching the leaf)
  * ``ctx.leaf_comm_duty()`` — per-leaf sum of resident jobs'
    communication duty cycles (:func:`repro_torch.core.patterns.comm_duty_cycle`)
    — the time-domain view behind ``contention-affinity-time``
    (docs/heterogeneous.md)

All views are maintained identically by the v1 and v2 engines (integer
arithmetic, or exactly-rounded ``fsum`` totals for the duty view), so a
placement decided from them cannot break the v1 ≡ v2 bit-parity contract.

Registry lifecycle: registration is process-global and normally happens at
import time.  Strategies registered at runtime are visible immediately
(``repro_torch.core.simulator.STRATEGIES`` is a live view), but campaign workers
(``run_campaign(workers=N)``) resolve names in fresh processes — a plugin
must be registered by an importable module to survive the fork.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from ..jobs import Job
from ..routing import Routing, SourceRouting
from ..scheduler import QUEUE_POLICIES
from ..topology import ClusterSpec

__all__ = [
    "Strategy", "register_strategy", "unregister_strategy", "get_strategy",
    "strategy_names", "registered_strategies",
]


class Strategy:
    """Base class / protocol of one scheduling scenario.

    Subclass, fill in the metadata attributes, override
    :meth:`make_routing` and :meth:`place`, and register the class (or an
    instance) with :func:`register_strategy`.  Registered instances are
    shared across simulators and processes — keep them **stateless**; all
    per-run state (routing tables, RNG draws) belongs in the objects
    ``make_routing`` returns or derives from ``ctx``.
    """

    #: unique registry key, e.g. ``"vclos"``
    name: str = ""
    #: one-line human description (``sweep campaign --list-strategies``)
    description: str = ""
    #: link reservation pins share = 1; the engines skip link accounting
    isolated: bool = False
    #: placements are realisable grants for the online ``IsolatedScheduler``
    #: (contention-free routing maps over physically reserved resources)
    grantable: bool = False
    #: placement needs an OCS layer (``spec.num_ocs > 0``) to function
    requires_ocs: bool = False
    #: campaigns should run this strategy on the ``*_OCS`` cluster preset
    #: when one is supplied via ``ocs_spec=``
    wants_ocs_spec: bool = False
    #: a failed placement is a pure function of ``FabricState`` — the v2
    #: engine may cache the failure until the fabric-state version bumps.
    #: Set False when placement can fail irreproducibly (e.g. a wall-clock
    #: -limited MILP).
    memoize_failures: bool = True
    #: running jobs may be checkpoint-migrated by the defragmentation pass
    #: (``SimConfig.defrag_interval``): the engines periodically try to
    #: re-place each running job through :meth:`place` and move it when the
    #: new placement is strictly more local (fewer leafs, then fewer
    #: servers), charging ``SimConfig.migration_iters`` of restart work.
    #: Leave False when a placement embeds state a re-place cannot rebuild
    #: (e.g. OCS cross-connect rewiring).
    supports_migration: bool = False
    #: queueing policies this strategy supports (subset of
    #: :data:`repro_torch.core.scheduler.QUEUE_POLICIES`)
    queue_policies: Tuple[str, ...] = QUEUE_POLICIES

    def make_routing(self, spec: ClusterSpec, seed: int) -> Routing:
        """Fresh routing instance for one simulation run (may be stateful —
        it is never shared across runs).  Default: the paper's static
        source routing."""
        return SourceRouting(spec)

    def place(self, ctx, job_id: int, num_gpus: int,
              job: Optional[Job] = None):
        """Try to place a job: return a
        :class:`repro_torch.core.placement.Placement` or a
        :class:`repro_torch.core.placement.PlacementFailure` tagging the
        bottleneck (``"gpu"`` | ``"network"``).

        Callers guarantee ``ctx.state.num_free_gpus() >= num_gpus`` (the
        O(1) fast-fail happens before dispatch).  ``job`` carries the full
        workload profile when the caller has one (the simulator always
        passes it; the online scheduler facade may not).
        """
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<Strategy {self.name!r}>"


_REGISTRY: Dict[str, Strategy] = {}


def register_strategy(strategy=None, *, replace: bool = False):
    """Register a :class:`Strategy` (class decorator or direct call).

    Accepts a ``Strategy`` subclass (instantiated with no arguments) or an
    instance.  Duplicate names raise unless ``replace=True``.  Returns the
    argument unchanged so it stacks as a decorator::

        @register_strategy
        class MyStrategy(Strategy):
            name = "my-strategy"
            ...
    """
    def _register(obj):
        inst = obj() if isinstance(obj, type) else obj
        if not isinstance(inst, Strategy):
            raise TypeError(f"register_strategy needs a Strategy subclass "
                            f"or instance, got {obj!r}")
        if not inst.name:
            raise ValueError(f"strategy {obj!r} has no name")
        if inst.name in _REGISTRY and not replace:
            raise ValueError(f"strategy {inst.name!r} already registered; "
                             f"pass replace=True to override")
        bad = [q for q in inst.queue_policies if q not in QUEUE_POLICIES]
        if bad:
            raise ValueError(f"strategy {inst.name!r} lists unknown "
                             f"queueing policies {bad}; "
                             f"choose from {QUEUE_POLICIES}")
        _REGISTRY[inst.name] = inst
        return obj

    if strategy is None:
        return _register
    return _register(strategy)


def unregister_strategy(name: str) -> None:
    """Remove a strategy from the registry (tests, plugin teardown)."""
    _REGISTRY.pop(name, None)


def get_strategy(strategy: Union[str, Strategy]) -> Strategy:
    """Resolve a name (or pass through an instance).  Unknown names raise
    with the full list of registered strategies — including any registered
    at runtime."""
    if isinstance(strategy, Strategy):
        return strategy
    if strategy not in _REGISTRY:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"choose from {strategy_names()}")
    return _REGISTRY[strategy]


def strategy_names() -> Tuple[str, ...]:
    """Registered strategy names, in registration order."""
    return tuple(_REGISTRY)


def registered_strategies() -> Dict[str, Strategy]:
    """Snapshot of the registry (name -> instance)."""
    return dict(_REGISTRY)


# Load the bundled plugins.  builtin must come first so the legacy
# STRATEGIES ordering ("best", "sr", ..., "ocs-relax") is preserved;
# contention_affinity registers itself through the public API above.
from . import builtin as _builtin                      # noqa: E402,F401
from . import contention_affinity as _affinity         # noqa: E402,F401
from . import contention_affinity_time as _affinity_t  # noqa: E402,F401
