"""Contention-affinity placement — the first external-style plugin.

CASSINI-inspired (Rajasekaran et al., 2023): instead of reserving links
(vClos) or ignoring traffic (the locality-packed baselines), score
candidate placements by their predicted link-overlap with the jobs already
running and pick the least-overlapping one.  Routing stays plain ECMP, so
any remaining overlap shows up as hash-collision contention — the strategy
only *steers around* busy leafs, it guarantees nothing.

Placement:
  * stage 0/1 as usual — single-server and single-leaf jobs never touch
    the fabric, so affinity cannot help them;
  * multi-leaf jobs rank leafs by ``ctx.leaf_link_load()`` (the running
    flow count on each leaf's uplinks + downlinks — integer, engine
    -agnostic), preferring quiet leafs, then fuller leafs (fewer leafs
    spanned), then lower ids, and take whole idle servers greedily.

Registered exclusively through the public :func:`register_strategy` API —
this module is the worked example for out-of-tree strategies
(``docs/strategies.md`` walks through it).
"""

from __future__ import annotations

import math

import numpy as np

from ..placement import Placement, PlacementFailure, stage0_server, stage1_leaf
from ..routing import ECMPRouting
from . import Strategy, register_strategy


@register_strategy
class ContentionAffinityStrategy(Strategy):
    name = "contention-affinity"
    description = ("CASSINI-style affinity: place multi-leaf jobs on the "
                   "least-contended leafs, ECMP routing")

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
        # rank: quiet leafs first, then most idle servers (span fewer
        # leafs), then lowest id — integer keys, so the order (and thus the
        # placement) is identical under both engines
        order = np.lexsort((np.arange(spec.num_leafs), -idle, load))
        servers = []
        for leaf in order.tolist():
            if not idle[leaf]:
                continue
            servers.extend(state.idle_servers_of_leaf(leaf)[:req - len(servers)])
            if len(servers) >= req:
                break
        gpus = [g for sv in servers for g in spec.gpus_of_server(sv)][:num_gpus]
        return Placement(job_id, gpus, "affinity")
