"""The paper's seven strategies, re-homed as registry plugins.

Each class carries the metadata the engines used to hard-code:
routing factory, placement function, isolation, OCS needs, and the
failure-memoisation policy.  Behaviour is identical to the pre-registry
string dispatch — the golden JCT snapshot and the v1 ≡ v2 bit-parity
tests pin that.
"""

from __future__ import annotations

import math

import numpy as np

from ..ocs import collect_idle_servers, ocs_vclos_place
from ..placement import (Placement, PlacementFailure, stage0_server,
                         stage1_leaf, vclos_place)
from ..routing import (BalancedECMPRouting, ECMPRouting, IdealRouting,
                       SourceRouting)
from . import Strategy, register_strategy


def locality_packed_place(ctx, job_id: int, num_gpus: int):
    """Shared baseline placement: best-fit one server (stage 0), else one
    leaf in whole idle servers (stage 1), else whole idle servers across
    leafs, fewest-idle first.  Public building block for plugins."""
    state, spec = ctx.state, ctx.spec
    if num_gpus <= spec.gpus_per_server:
        p = stage0_server(state, job_id, num_gpus)
        return p if p else PlacementFailure("gpu")
    p = stage1_leaf(state, job_id, num_gpus)
    if p is not None:
        return p
    servers = collect_idle_servers(state,
                                   math.ceil(num_gpus / spec.gpus_per_server))
    if servers is None:
        return PlacementFailure("gpu")
    gpus = [g for sv in servers for g in spec.gpus_of_server(sv)][:num_gpus]
    return Placement(job_id, gpus, "multi-leaf")


@register_strategy
class BestStrategy(Strategy):
    name = "best"
    description = "ideal single big switch: contention-free upper bound"
    isolated = True
    supports_migration = True

    def make_routing(self, spec, seed):
        return IdealRouting(spec)

    def place(self, ctx, job_id, num_gpus, job=None):
        return locality_packed_place(ctx, job_id, num_gpus)


@register_strategy
class SourceRoutingStrategy(Strategy):
    name = "sr"
    description = "static per-leaf source routing, locality-packed, no isolation"

    def place(self, ctx, job_id, num_gpus, job=None):
        return locality_packed_place(ctx, job_id, num_gpus)


@register_strategy
class ECMPStrategy(Strategy):
    name = "ecmp"
    description = "5-tuple-hash routing per flow: the hash-collision baseline"

    def make_routing(self, spec, seed):
        return ECMPRouting(spec, seed=seed)

    def place(self, ctx, job_id, num_gpus, job=None):
        return locality_packed_place(ctx, job_id, num_gpus)


@register_strategy
class BalancedStrategy(Strategy):
    name = "balanced"
    description = "least-loaded uplink choice at flow start (§9.3 Balanced)"

    def make_routing(self, spec, seed):
        return BalancedECMPRouting(spec, seed=seed)

    def place(self, ctx, job_id, num_gpus, job=None):
        return locality_packed_place(ctx, job_id, num_gpus)


@register_strategy
class VClosStrategy(Strategy):
    name = "vclos"
    description = "exclusive virtual sub-Clos per job (stages 0-2 + FINDVCLOS ILP)"
    isolated = True
    grantable = True
    # stage-2 falls back to a wall-clock-limited MILP: a timeout failure is
    # not reproducible, so the v2 engine must retry instead of caching it
    memoize_failures = False
    # isolated placements pin no cross-connect state, so checkpoint
    # migration can repack them to reclaim contiguous leaf capacity
    supports_migration = True

    def place(self, ctx, job_id, num_gpus, job=None):
        return vclos_place(ctx.state, job_id, num_gpus,
                           ilp_time_limit=ctx.ilp_time_limit)


@register_strategy
class OCSVClosStrategy(Strategy):
    name = "ocs-vclos"
    description = "vClos + OCS rewiring of idle circuits (Algorithm 2/4)"
    isolated = True
    grantable = True
    requires_ocs = True
    wants_ocs_spec = True

    def place(self, ctx, job_id, num_gpus, job=None):
        return ocs_vclos_place(ctx.state, job_id, num_gpus)


@register_strategy
class OCSRelaxStrategy(Strategy):
    name = "ocs-relax"
    description = "locality constraint relaxed: scattered GPUs (Table 5 caution)"
    wants_ocs_spec = True

    def place(self, ctx, job_id, num_gpus, job=None):
        # grab any free GPUs, scattered; per-job RNG derived from the run seed
        state, spec = ctx.state, ctx.spec
        free = [g for g in range(spec.num_gpus) if state.gpu_free(g)]
        if len(free) < num_gpus:
            return PlacementFailure("gpu")
        rng = np.random.default_rng(ctx.seed + job_id)
        gpus = sorted(rng.choice(len(free), size=num_gpus,
                                 replace=False).tolist())
        return Placement(job_id, [free[i] for i in gpus], "relaxed")
