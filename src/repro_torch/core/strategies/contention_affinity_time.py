"""Contention-affinity-time placement — phase-aware (time-domain) affinity.

Extends ``contention-affinity`` from *where* to *when* (CASSINI's second
insight, Rajasekaran et al., 2023): two jobs sharing a leaf's uplinks only
hurt each other while both are inside their communication windows.  Each
job model has a compute/communicate duty cycle
(:func:`repro_torch.core.patterns.comm_duty_cycle`); as long as the duty cycles
of co-located jobs sum to ≤ 1, their windows can interleave and the
predicted collision (:func:`repro_torch.core.patterns.duty_overflow`) is zero.

Placement therefore ranks candidate leafs primarily by the *overflow this
job would cause* — ``max(0, resident_duty + own_duty − 1)`` via the
``ctx.leaf_comm_duty()`` placement view — and only then by the plain
flow-count load / idle-server keys of the offset-blind plugin.  A
compute-heavy job (duty ≈ 0) scores every leaf 0 and degenerates to
``contention-affinity`` exactly; a comm-heavy job steers away from leafs
already saturated with communicators even when their instantaneous flow
counts look equal.

Scoring only: routing stays ECMP and the fluid rate model is untouched, so
the v1≡v2 bit-parity contract holds (``tests/test_hetero.py``).
"""

from __future__ import annotations

import math

import numpy as np

from ..patterns import comm_duty_cycle, duty_overflow
from ..placement import Placement, PlacementFailure, stage0_server, stage1_leaf
from ..routing import ECMPRouting
from . import Strategy, register_strategy


@register_strategy
class ContentionAffinityTimeStrategy(Strategy):
    name = "contention-affinity-time"
    description = ("phase-aware affinity: rank leafs by communication "
                   "duty-cycle compatibility, then load; ECMP routing")

    def make_routing(self, spec, seed):
        return ECMPRouting(spec, seed=seed)

    def place(self, ctx, job_id, num_gpus, job=None):
        state, spec = ctx.state, ctx.spec
        if num_gpus <= spec.gpus_per_server:
            p = stage0_server(state, job_id, num_gpus)
            return p if p else PlacementFailure("gpu")
        p = stage1_leaf(state, job_id, num_gpus)
        if p is not None:
            return p
        req = math.ceil(num_gpus / spec.gpus_per_server)
        idle = state.idle_server_counts()           # whole idle servers/leaf
        if int(idle.sum()) < req:
            return PlacementFailure("gpu")
        load = ctx.leaf_link_load()
        duty = ctx.leaf_comm_duty()
        own = comm_duty_cycle(job, spec.link_gbps) if job is not None else 0.0
        # predicted time-domain collision per leaf if this job lands there;
        # exact (fsum-backed) floats, so the order — and the placement —
        # is identical under both engines.  Ties (own duty 0, or an
        # uncontended fleet) fall through to the offset-blind keys,
        # reproducing contention-affinity's choice bit-for-bit.
        overflow = np.asarray([duty_overflow((float(d), own)) for d in duty])
        order = np.lexsort((np.arange(spec.num_leafs), -idle, load, overflow))
        servers = []
        for leaf in order.tolist():
            if not idle[leaf]:
                continue
            servers.extend(state.idle_servers_of_leaf(leaf)[:req - len(servers)])
            if len(servers) >= req:
                break
        gpus = [g for sv in servers for g in spec.gpus_of_server(sv)][:num_gpus]
        return Placement(job_id, gpus, "affinity-time")
