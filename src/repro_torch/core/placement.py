"""vClos resource scheduling (paper §6 + Appendix A.2).

Stages (Algorithm 1):
  * Stage 0 — ``N ≤ T``: best-fit into one server (locality).
  * Stage 1 — ``N > T``: best-fit under one leaf (no spine ports consumed).
  * Stage 2 — FINDVCLOS (Algorithm 3): factor ``N = l × s`` starting from
    ``l = max(1, 2^⌊log2 N⌋ / S)`` and doubling; for each (l, s) solve the
    eq.(2)–(6) ILP choosing ``l`` leafs, ``s`` spines and the reserved links.
    A fast greedy solver runs first; the exact HiGHS MILP
    (``scipy.optimize.milp``) is the fallback, matching the paper's solver
    behaviour (~1 s on a 2048-GPU cluster).

A successful stage-2 placement yields an exclusive virtual Leaf-Spine
sub-topology (`VirtualClos`) plus the per-leaf source-routing maps over the
reserved uplinks — contention-free for every Leaf-wise Permutation phase by
Lemma 5.1.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .topology import ClusterSpec, FabricState


@dataclass
class VirtualClos:
    """An exclusive sub-Clos: ``l`` virtual leafs × ``s`` virtual spines."""

    leafs: List[int]                       # physical leaf ids, rank-block order
    spines: List[int]                      # physical spine ids
    links: Dict[Tuple[int, int], int]      # (leaf, spine) -> reserved channels
    gpus_per_leaf: int                     # = s (GPUs of this job under each leaf)

    @property
    def num_leafs(self) -> int:
        return len(self.leafs)

    @property
    def num_spines(self) -> int:
        return len(self.spines)


@dataclass
class Placement:
    job_id: int
    gpus: List[int]                        # physical GPU ids in logical-rank order
    kind: str                              # "server" | "leaf" | "vclos" | "best"
    vclos: Optional[VirtualClos] = None
    # per-leaf source-routing map: leaf -> {server_port -> (spine, channel)}
    routing_maps: Dict[int, Dict[int, Tuple[int, int]]] = field(default_factory=dict)
    overallocated: int = 0                 # GPUs allocated beyond request (N→N_new)
    # OCS leaf ports unwired for a direct leaf↔leaf cross-connect
    xconn_ports: List[Tuple[int, int, int]] = field(default_factory=list)


@dataclass
class PlacementFailure:
    reason: str                            # "gpu" | "network"


# ---------------------------------------------------------------------------
# Stage 0 / Stage 1 heuristics
# ---------------------------------------------------------------------------

def stage0_server(state: FabricState, job_id: int, n: int) -> Optional[Placement]:
    """Best-fit into the server with the fewest idle GPUs that still fits.

    Vectorized over the maintained per-server idle counts; ``argmin`` keeps
    the scalar loop's tie-break (lowest server id among the best fits).
    Public building block for strategy plugins (docs/strategies.md)."""
    free = state.server_free_array()
    cand = np.flatnonzero(free >= n)
    if not len(cand):
        return None
    best = int(cand[np.argmin(free[cand])])
    gpus = state.idle_gpus_of_server(best)[:n]
    return Placement(job_id, gpus, "server")


def stage1_leaf(state: FabricState, job_id: int, n: int) -> Optional[Placement]:
    """Best-fit under one leaf; whole idle servers only (locality, §6.1).
    Public building block for strategy plugins (docs/strategies.md)."""
    spec = state.spec
    req_servers = math.ceil(n / spec.gpus_per_server)
    counts = state.idle_server_counts()
    cand = np.flatnonzero(counts >= req_servers)
    if not len(cand):
        return None
    best = int(cand[np.argmin(counts[cand])])
    servers = state.idle_servers_of_leaf(best)[:req_servers]
    gpus = [g for sv in servers for g in spec.gpus_of_server(sv)][:n]
    return Placement(job_id, gpus, "leaf")


# ---------------------------------------------------------------------------
# Stage 2: FINDVCLOS
# ---------------------------------------------------------------------------

def _factorizations(n: int, spec: ClusterSpec) -> List[Tuple[int, int]]:
    """(l, s) candidates: all divisor pairs l·s = n with T | s,
    s/T ≤ servers/leaf, s ≤ num_spines, 2 ≤ l ≤ num_leafs.

    Ordered to match Algorithm 3's preference (appendix A.2: "the number of
    ports in each virtual leaf as large as possible to a power of 2"):
    power-of-two ``s`` first, then larger ``s`` (fewer leafs).  This strictly
    generalises the paper's doubling sweep — e.g. N=160 on CLUSTER512 admits
    (l=5, s=32), which pure doubling misses and would bump to N_new=192.
    """
    out: List[Tuple[int, int]] = []
    for l in range(2, min(n, spec.num_leafs) + 1):
        if n % l:
            continue
        s = n // l
        if (s % spec.gpus_per_server == 0
                and s // spec.gpus_per_server <= spec.servers_per_leaf
                and s <= spec.num_spines):
            out.append((l, s))
    out.sort(key=lambda ls: (0 if (ls[1] & (ls[1] - 1)) == 0 else 1, -ls[1]))
    return out


def candidate_sizes(n: int, spec: ClusterSpec, max_bump: int = 64) -> List[int]:
    """N, then the smallest N_new > N admitting a factorization (paper §6.1:
    bump to the next composite when N itself cannot form a vClos)."""
    sizes = [n]
    m = n + 1
    while len(sizes) < 2 and m <= n + max_bump:
        if _factorizations(m, spec):
            sizes.append(m)
        m += 1
    return sizes


def _greedy_vclos(state: FabricState, l: int, s: int,
                  cap: List[List[int]]) -> Optional[Tuple[List[int], List[int]]]:
    """Fast path: best-fit leaf choice, then spine set covered by all leafs."""
    spec = state.spec
    req_servers = s // spec.gpus_per_server
    # candidate leafs with enough idle servers, best-fit order (fewest idle)
    cands = [(len(state.idle_servers_of_leaf(n)), n)
             for n in range(spec.num_leafs)
             if len(state.idle_servers_of_leaf(n)) >= req_servers]
    if len(cands) < l:
        return None
    cands.sort()
    for combo_start in range(len(cands) - l + 1):
        leafs = [n for _, n in cands[combo_start:combo_start + l]]
        # spines with a free channel to *every* chosen leaf
        ok_spines = [m for m in range(spec.num_spines)
                     if all(cap[n][m] - state.reserved(n, m) >= 1 for n in leafs)]
        if len(ok_spines) >= s:
            # best-fit spines: fewest free ports first (paper eq. 6)
            ok_spines.sort(key=lambda m: state.spine_free_ports(m, cap))
            return leafs, ok_spines[:s]
    return None


def _ilp_vclos(state: FabricState, l: int, s: int, cap: List[List[int]],
               time_limit: float = 5.0) -> Optional[Tuple[List[int], List[int]]]:
    """Exact eq.(2)–(6) MILP via HiGHS.  Variables: l_n (L), s_m (S),
    c_{n,m} (L×S), all binary (channel use per pair is 0/1 in a vClos)."""
    from scipy.optimize import Bounds, LinearConstraint, milp
    spec = state.spec
    L, S = spec.num_leafs, spec.num_spines
    req_servers = s // spec.gpus_per_server
    nl, ns, nc = L, S, L * S
    nvar = nl + ns + nc

    def cvar(n: int, m: int) -> int:
        return nl + ns + n * S + m

    ub = np.ones(nvar)
    for n in range(L):
        if len(state.idle_servers_of_leaf(n)) < req_servers:
            ub[n] = 0  # leaf ineligible (eq. 5 server constraint)
        for m in range(S):
            if cap[n][m] - state.reserved(n, m) < 1:
                ub[cvar(n, m)] = 0  # no free channel (eq. 4)
    A_rows, lb_rows, ub_rows = [], [], []

    def add(row: np.ndarray, lo: float, hi: float) -> None:
        A_rows.append(row)
        lb_rows.append(lo)
        ub_rows.append(hi)

    row = np.zeros(nvar); row[:nl] = 1; add(row, l, l)           # Σ l_n = l
    row = np.zeros(nvar); row[nl:nl + ns] = 1; add(row, s, s)    # Σ s_m = s
    for n in range(L):  # Σ_m c_{n,m} = s · l_n   (eq. 3 upper)
        row = np.zeros(nvar)
        for m in range(S):
            row[cvar(n, m)] = 1
        row[n] = -s
        add(row, 0, 0)
    for m in range(S):  # Σ_n c_{n,m} = l · s_m   (eq. 3 lower)
        row = np.zeros(nvar)
        for n in range(L):
            row[cvar(n, m)] = 1
        row[nl + m] = -l
        add(row, 0, 0)
    for n in range(L):  # c ≤ s_m  (c ≤ l_n is implied by the row sums)
        for m in range(S):
            row = np.zeros(nvar)
            row[cvar(n, m)] = 1
            row[nl + m] = -1
            add(row, -np.inf, 0)

    # objective (eq. 6): best-fit packing of spines and leafs
    cost = np.zeros(nvar)
    for m in range(S):
        cost[nl + m] = state.spine_free_ports(m, cap)
    for n in range(L):
        cost[n] = len(state.idle_servers_of_leaf(n)) * spec.gpus_per_server
    res = milp(c=cost,
               constraints=LinearConstraint(np.array(A_rows),
                                            np.array(lb_rows), np.array(ub_rows)),
               integrality=np.ones(nvar),
               bounds=Bounds(np.zeros(nvar), ub),
               options={"time_limit": time_limit, "presolve": True})
    if not res.success:
        return None
    x = np.round(res.x).astype(int)
    leafs = [n for n in range(L) if x[n] == 1]
    spines = [m for m in range(S) if x[nl + m] == 1]
    return leafs, spines


def find_vclos(state: FabricState, job_id: int, n: int,
               use_ilp: bool = True,
               ilp_time_limit: float = 5.0) -> Optional[Placement]:
    """FINDVCLOS (Algorithm 3) over candidate sizes and factorizations."""
    spec = state.spec
    cap = state.capacity()
    for size in candidate_sizes(n, spec):
        for l, s in _factorizations(size, spec):
            sol = _greedy_vclos(state, l, s, cap)
            if sol is None and use_ilp:
                sol = _ilp_vclos(state, l, s, cap, ilp_time_limit)
            if sol is None:
                continue
            leafs, spines = sol
            return _materialize(state, job_id, n, leafs, spines, s,
                                overalloc=size - n)
    return None


def _materialize(state: FabricState, job_id: int, n_requested: int,
                 leafs: List[int], spines: List[int], s: int,
                 overalloc: int) -> Placement:
    """Pick servers, build rank-ordered GPU list, links and routing maps."""
    spec = state.spec
    req_servers = s // spec.gpus_per_server
    gpus: List[int] = []
    links: Dict[Tuple[int, int], int] = {}
    routing_maps: Dict[int, Dict[int, Tuple[int, int]]] = {}
    for leaf in leafs:
        servers = state.idle_servers_of_leaf(leaf)[:req_servers]
        leaf_gpus = [g for sv in servers for g in spec.gpus_of_server(sv)]
        gpus.extend(leaf_gpus)
        rmap: Dict[int, Tuple[int, int]] = {}
        for idx, g in enumerate(leaf_gpus):
            # job-local port idx -> idx-th reserved spine (injective per leaf)
            rmap[spec.port_of_gpu(g)] = (spines[idx % len(spines)], 0)
        routing_maps[leaf] = rmap
        for m in spines:
            links[(leaf, m)] = 1
    vclos = VirtualClos(leafs=list(leafs), spines=list(spines), links=links,
                        gpus_per_leaf=s)
    return Placement(job_id, gpus[:n_requested] if overalloc == 0 else gpus,
                     "vclos", vclos=vclos, routing_maps=routing_maps,
                     overallocated=overalloc)


# ---------------------------------------------------------------------------
# Top-level vClos scheduler entry (Algorithm 1)
# ---------------------------------------------------------------------------

def vclos_place(state: FabricState, job_id: int, n: int,
                use_ilp: bool = True,
                ilp_time_limit: float = 5.0):
    """Returns a Placement, or PlacementFailure tagging the bottleneck
    resource ("gpu" vs "network") for the paper's Table-2 accounting."""
    spec = state.spec
    if n <= spec.gpus_per_server:
        p = stage0_server(state, job_id, n)
        return p if p else PlacementFailure("gpu")
    p = stage1_leaf(state, job_id, n)
    if p is not None:
        return p
    p = find_vclos(state, job_id, n, use_ilp, ilp_time_limit)
    if p is not None:
        return p
    # enough idle whole servers anywhere? then the block is network-caused
    idle_servers = sum(1 for sv in range(spec.num_servers) if state.server_idle(sv))
    need = math.ceil(n / spec.gpus_per_server)
    return PlacementFailure("network" if idle_servers >= need else "gpu")


# deprecated aliases (pre-registry names; strategy plugins use the public ones)
_stage0_server = stage0_server
_stage1_leaf = stage1_leaf


def commit(state: FabricState, p: Placement) -> None:
    state.allocate_gpus(p.job_id, p.gpus)
    if p.vclos is not None:
        state.reserve_links(p.job_id, p.vclos.links)
    for k, lp, _orig in p.xconn_ports:
        state.xconn_owner[(k, lp)] = p.job_id


def release(state: FabricState, job_id: int,
            placement: Optional[Placement] = None) -> None:
    state.release_job(job_id,
                      gpus=placement.gpus if placement is not None else None)
