"""Collective-communication traffic generators (paper §4.2, §5.3).

Every generator maps a rank list (``ranks[i]`` = GPU id of logical rank
``i``) to a sequence of *phases*.  A phase is a list of concurrent
:class:`Flow` s — one communication round of the collective.  The paper's
Lemma 5.1 analysis applies phase by phase: each phase of a conforming
collective is a Leaf-wise Permutation Traffic Pattern.

Generators also expose *executable* schedules (`run_*` helpers) that move
real numpy buffers so unit tests can verify the collectives compute the
correct result, not just the intended flow pattern.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np


@dataclass(frozen=True)
class Flow:
    src: int  # GPU id
    dst: int  # GPU id
    nbytes: float

    def __iter__(self):
        return iter((self.src, self.dst, self.nbytes))


Phase = List[Flow]


# ---------------------------------------------------------------------------
# Ring-AllReduce (scatter-reduce + all-gather), §5.3
# ---------------------------------------------------------------------------

def ring_allreduce(ranks: Sequence[int], nbytes: float) -> List[Phase]:
    """2(N-1) rounds; round t: rank i sends one 1/N chunk to rank i+1."""
    n = len(ranks)
    if n < 2:
        return []
    chunk = nbytes / n
    phase = [Flow(ranks[i], ranks[(i + 1) % n], chunk) for i in range(n)]
    return [list(phase) for _ in range(2 * (n - 1))]


def hierarchical_ring_allreduce(ranks: Sequence[int], nbytes: float,
                                group: int) -> List[Phase]:
    """Hierarchical ring: intra-group rings, inter-group ring of leaders,
    intra-group broadcast rings.  ``group`` is typically GPUs-per-server so
    the inner rings ride NVLink.  Each plane is an independent ring
    (paper: "construct an independent communication plane for each ring").
    """
    n = len(ranks)
    if n <= group or n % group:
        return ring_allreduce(ranks, nbytes)
    phases: List[Phase] = []
    groups = [list(ranks[i:i + group]) for i in range(0, n, group)]
    # 1. intra-group reduce (ring over each group, concurrent across groups)
    for p in ring_allreduce(range(group), nbytes):
        phases.append([Flow(g[f.src], g[f.dst], f.nbytes) for g in groups
                       for f in p])
    # 2. leader ring across groups
    leaders = [g[0] for g in groups]
    phases.extend(ring_allreduce(leaders, nbytes))
    # 3. intra-group broadcast (reuse ring pattern)
    for p in ring_allreduce(range(group), nbytes):
        phases.append([Flow(g[f.src], g[f.dst], f.nbytes) for g in groups
                       for f in p])
    return phases


# ---------------------------------------------------------------------------
# Recursive Halving-Doubling (§5.3), incl. non-power-of-two pre/post step
# ---------------------------------------------------------------------------

def halving_doubling_allreduce(ranks: Sequence[int], nbytes: float) -> List[Phase]:
    n = len(ranks)
    if n < 2:
        return []
    pow2 = 1 << int(math.floor(math.log2(n)))
    extra = n - pow2
    phases: List[Phase] = []
    # pre-step (paper §5.3): rank i ∈ [0, extra) folds into rank i + pow2;
    # the remaining pow2 ranks [extra, n) form the power-of-two core.
    if extra:
        phases.append([Flow(ranks[i], ranks[i + pow2], nbytes) for i in range(extra)])
    core = [ranks[extra + i] for i in range(pow2)]
    # reduce-scatter: step t exchanges with rank i ^ 2^t, halving data
    sz = nbytes / 2
    steps = int(math.log2(pow2))
    for t in range(steps):
        d = 1 << t
        phases.append([Flow(core[i], core[i ^ d], sz) for i in range(pow2)])
        sz /= 2
    # all-gather: reverse distances, doubling data
    sz = nbytes / pow2
    for t in reversed(range(steps)):
        d = 1 << t
        phases.append([Flow(core[i], core[i ^ d], sz) for i in range(pow2)])
        sz *= 2
    if extra:
        phases.append([Flow(ranks[i + pow2], ranks[i], nbytes) for i in range(extra)])
    return phases


# ---------------------------------------------------------------------------
# Pairwise AlltoAll (expert parallelism, §5.3)
# ---------------------------------------------------------------------------

def pairwise_alltoall(ranks: Sequence[int], nbytes: float) -> List[Phase]:
    """N-1 steps; step t: rank i sends its share to rank (i+t+1) mod N."""
    n = len(ranks)
    if n < 2:
        return []
    share = nbytes / n
    return [[Flow(ranks[i], ranks[(i + t + 1) % n], share) for i in range(n)]
            for t in range(n - 1)]


# ---------------------------------------------------------------------------
# Pipeline send/recv (§5.3)
# ---------------------------------------------------------------------------

def pipeline_p2p(ranks: Sequence[int], nbytes: float,
                 backward: bool = False) -> List[Phase]:
    n = len(ranks)
    if n < 2:
        return []
    if backward:
        return [[Flow(ranks[i], ranks[i - 1], nbytes) for i in range(1, n)]]
    return [[Flow(ranks[i], ranks[i + 1], nbytes) for i in range(n - 1)]]


# ---------------------------------------------------------------------------
# Double binary tree (§5.3 "does not follow the pattern" example)
# ---------------------------------------------------------------------------

def double_binary_tree_allreduce(ranks: Sequence[int], nbytes: float) -> List[Phase]:
    """NCCL-style double binary tree: two trees, each reducing half the data.

    Included because the paper uses it as the example of a collective that is
    *not* a leaf-wise permutation (up to L flows may contend under source
    routing, vs L*S under ECMP).
    """
    n = len(ranks)
    if n < 2:
        return []
    half = nbytes / 2

    def tree_edges(order: Sequence[int]) -> List[Flow]:
        # complete binary tree over `order`, child -> parent reduce flows
        flows = []
        for i in range(1, n):
            parent = (i - 1) // 2
            flows.append(Flow(order[i], order[parent], half))
        return flows

    t1 = list(ranks)
    t2 = list(ranks[1:]) + [ranks[0]]  # shifted tree (ranks swap roles)
    up = [tree_edges(t1) + tree_edges(t2)]
    down = [[Flow(f.dst, f.src, f.nbytes) for f in up[0]]]
    return up + down


# ---------------------------------------------------------------------------
# Executable schedules (for correctness tests)
# ---------------------------------------------------------------------------

def run_ring_allreduce(buffers: List[np.ndarray]) -> List[np.ndarray]:
    """Execute ring allreduce (scatter-reduce + all-gather) on real buffers."""
    n = len(buffers)
    if n == 1:
        return [buffers[0].copy()]
    size = buffers[0].size
    chunks = [np.array_split(b.astype(np.float64).copy(), n) for b in buffers]
    # scatter-reduce: round t, rank i sends chunk (i - t) mod n to i+1
    for t in range(n - 1):
        incoming = [(chunks[(i - 1) % n][(i - 1 - t) % n]).copy() for i in range(n)]
        for i in range(n):
            chunks[i][(i - 1 - t) % n] = chunks[i][(i - 1 - t) % n] + incoming[i]
    # all-gather: round t, rank i sends its reduced chunk (i + 1 - t) mod n
    for t in range(n - 1):
        incoming = [(chunks[(i - 1) % n][(i - t) % n]).copy() for i in range(n)]
        for i in range(n):
            chunks[i][(i - t) % n] = incoming[i]
    return [np.concatenate(c) for c in chunks]


def run_halving_doubling_allreduce(buffers: List[np.ndarray]) -> List[np.ndarray]:
    """Execute recursive halving-doubling allreduce (power-of-two + fold)."""
    n = len(buffers)
    bufs = [b.astype(np.float64).copy() for b in buffers]
    pow2 = 1 << int(math.floor(math.log2(n)))
    extra = n - pow2
    for i in range(extra):  # pre-fold: rank i folds into rank i + pow2
        bufs[i + pow2] = bufs[i + pow2] + bufs[i]
    # core ranks are [extra, n); core index c corresponds to rank extra + c
    vals = [bufs[extra + i] for i in range(pow2)]
    steps = int(math.log2(pow2))
    # reduce-scatter with owned-segment bookkeeping
    seg = [(0, vals[0].size) for _ in range(pow2)]
    for t in range(steps):
        d = 1 << t
        new_vals = [v.copy() for v in vals]
        new_seg = list(seg)
        for i in range(pow2):
            j = i ^ d
            lo, hi = seg[i]
            mid = (lo + hi) // 2
            if i < j:  # keep lower half
                new_vals[i][lo:mid] = vals[i][lo:mid] + vals[j][lo:mid]
                new_seg[i] = (lo, mid)
            else:
                new_vals[i][mid:hi] = vals[i][mid:hi] + vals[j][mid:hi]
                new_seg[i] = (mid, hi)
        vals, seg = new_vals, new_seg
    for t in reversed(range(steps)):
        d = 1 << t
        new_vals = [v.copy() for v in vals]
        new_seg = list(seg)
        for i in range(pow2):
            j = i ^ d
            lo_i, hi_i = seg[i]
            lo_j, hi_j = seg[j]
            new_vals[i][lo_j:hi_j] = vals[j][lo_j:hi_j]
            new_seg[i] = (min(lo_i, lo_j), max(hi_i, hi_j))
        vals, seg = new_vals, new_seg
    out: List[np.ndarray] = [None] * n  # type: ignore[list-item]
    for c in range(pow2):  # core index c holds rank extra + c's result
        out[extra + c] = vals[c]
    for i in range(extra):  # post-step: rank i + pow2 sends result back to i
        out[i] = vals[i + pow2 - extra].copy()
    return out


def run_pairwise_alltoall(buffers: List[np.ndarray]) -> List[np.ndarray]:
    """Execute pairwise all-to-all: buffers[i] split into n shares;
    output[j] = concat of share j of every rank."""
    n = len(buffers)
    shares = [np.array_split(b, n) for b in buffers]
    return [np.concatenate([shares[i][j] for i in range(n)]) for j in range(n)]


ALGORITHMS: dict = {
    "ring": ring_allreduce,
    "hd": halving_doubling_allreduce,
    "hierarchical_ring": hierarchical_ring_allreduce,
    "alltoall": pairwise_alltoall,
    "pipeline": pipeline_p2p,
    "double_binary_tree": double_binary_tree_allreduce,
}


def total_bytes(phases: List[Phase]) -> float:
    return sum(f.nbytes for p in phases for f in p)


def max_phase_bytes_per_flow(phases: List[Phase]) -> float:
    return max((f.nbytes for p in phases for f in p), default=0.0)
