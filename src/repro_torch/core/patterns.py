"""Leaf-wise Permutation Traffic Pattern (paper Definition 1) checker.

A phase conforms iff:
  1. it is a (partial) permutation on GPUs — every GPU sends at most one flow
     and receives at most one flow;
  2. the *cross-leaf* flows induce an injective relation on leafs: flows
     leaving different source leafs never target the same destination leaf
     (Definition 1's final sentence), and no flow's source leaf equals its
     destination leaf by construction of "cross-leaf".

Lemma 5.1: any source-routing strategy is contention-free for any phase
passing this check.  This module is used by property tests and by the
placement validator (a vClos certifies contention-freedom by checking the
job's declared traffic phases against its virtual sub-topology).

It also hosts the **phase-offset (duty-cycle) model** behind time-domain
interleaving (docs/heterogeneous.md): each job model alternates compute
and communication within an iteration; :func:`comm_duty_cycle` is the
fraction of the iteration spent in *uncoverable* communication, and
:func:`duty_overflow` predicts how badly co-located jobs' communication
windows must collide (CASSINI-style compatibility).  Both are placement
*scores* — the fluid rate model itself is unchanged, so engine bit-parity
is untouched.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Set, Tuple

from .topology import ClusterSpec
from .traffic import Flow, Phase


def is_permutation(phase: Phase) -> bool:
    srcs = [f.src for f in phase]
    dsts = [f.dst for f in phase]
    return len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)


def cross_leaf_flows(phase: Phase, spec: ClusterSpec) -> List[Flow]:
    return [f for f in phase
            if spec.leaf_of_gpu(f.src) != spec.leaf_of_gpu(f.dst)]


def is_leafwise_permutation(phase: Phase, spec: ClusterSpec) -> bool:
    """Definition 1 check for one concurrent phase."""
    if not is_permutation(phase):
        return False
    seen: dict = {}  # dst_leaf -> src_leaf
    for f in cross_leaf_flows(phase, spec):
        j = spec.leaf_of_gpu(f.src)
        k = spec.leaf_of_gpu(f.dst)
        if k in seen and seen[k] != j:
            return False  # two different source leafs target leaf k
        seen[k] = j
    return True


def all_phases_leafwise(phases: Sequence[Phase], spec: ClusterSpec) -> bool:
    return all(is_leafwise_permutation(p, spec) for p in phases)


def violating_phases(phases: Sequence[Phase],
                     spec: ClusterSpec) -> List[int]:
    return [i for i, p in enumerate(phases)
            if not is_leafwise_permutation(p, spec)]


def leaf_traffic_matrix(phase: Phase, spec: ClusterSpec) -> List[List[int]]:
    """#cross-leaf flows per (src_leaf, dst_leaf) — diagnostic for tests."""
    mat = [[0] * spec.num_leafs for _ in range(spec.num_leafs)]
    for f in cross_leaf_flows(phase, spec):
        mat[spec.leaf_of_gpu(f.src)][spec.leaf_of_gpu(f.dst)] += 1
    return mat


def remap(phase: Phase, rank_to_gpu: Sequence[int]) -> Phase:
    """Relabel a phase expressed over logical ranks onto physical GPUs."""
    return [Flow(rank_to_gpu[f.src], rank_to_gpu[f.dst], f.nbytes)
            for f in phase]


# ---------------------------------------------------------------------------
# Phase-offset model: compute/communicate duty cycles (time-domain
# interleaving, docs/heterogeneous.md)
# ---------------------------------------------------------------------------

def comm_duty_cycle(job, link_gbps: float = 100.0) -> float:
    """Fraction of one contention-free iteration this job spends in
    *uncoverable* communication (the duty cycle of its network phase).

    Uses the same per-iteration model as the simulator at share = 1:
    allreduce overlaps with β of backward compute, AlltoAll sits on the
    critical path.  Compute-heavy models (ResNets, large-batch BERT)
    hide their allreduce entirely → duty 0; AlltoAll models (MoE, DLRM)
    and small-batch VGG16 expose long windows → duty 0.4-0.8.  Placement
    scoring only — never fed back into rate resolution.
    """
    if job.num_gpus <= 1:
        return 0.0
    from .jobs import GBPS                  # local: avoid an import cycle
    c = job.compute_time()
    ar, a2a = job.comm_bytes()
    bw = link_gbps * GBPS
    t_comm = max(0.0, ar / bw - job.profile.overlap_beta * c) + a2a / bw
    total = c + t_comm
    return t_comm / total if total > 0 else 0.0


def duty_overflow(duties: Sequence[float]) -> float:
    """Predicted time-domain collision of co-located jobs: how far the
    summed communication duty cycles exceed one link-time unit.  0 means
    the jobs' communication windows can interleave without overlap
    (phase-compatible); positive values grow with forced contention.

    ``math.fsum`` (exactly-rounded summation) makes the score independent
    of the order jobs are enumerated in — scheduling decisions must not
    depend on dict iteration order (property-tested)."""
    return max(0.0, math.fsum(duties) - 1.0)
