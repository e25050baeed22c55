"""OCS-vClos: optical-circuit-switch assisted vClos (paper §7 + Appendix A.3).

Pipeline (Algorithm 2):
  * Stage 0/1 — identical to vClos (single server / single leaf).
  * Stage 2  — single-spine virtual Clos: rewire idle circuits so every job
    GPU's uplink lands on one spine; any permutation is then contention-free
    (each GPU owns its uplink and its downlink).  Includes the paper's
    special 2-leaf case: direct leaf↔leaf OCS circuits using **zero** spine
    ports (Fig. 3).
  * Stage 3  — OCSFINDCLOS (Algorithm 4): general ``l × s`` vClos where link
    capacity is *made* by rewiring rather than found.  We solve the
    aggregated port-count ILP (eqs. 7–11 with the per-OCS index summed out —
    exact port-conservation constraints, see DESIGN.md) and then realise the
    circuits per OCS with greedy swaps; realisation failure falls back to
    the next (l, s) candidate.

Only *idle* circuits are ever moved (50 ms OCS switching would drop live
traffic, §7): a circuit is movable iff the (leaf, spine) channel it realises
has spare unreserved capacity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .placement import (Placement, PlacementFailure, VirtualClos,
                        stage0_server, stage1_leaf, _factorizations,
                        candidate_sizes)
from .topology import ClusterSpec, FabricState


# ---------------------------------------------------------------------------
# Rewiring engine
# ---------------------------------------------------------------------------

class RewirePlanner:
    """Plans circuit swaps to create requested (leaf, spine) capacity.

    Works against live OCS state; movable = circuit whose channel has spare
    (unreserved, unpinned) capacity.  All moves are collected and applied
    atomically by the caller via ``apply``.
    """

    def __init__(self, state: FabricState):
        assert state.ocs is not None, "OCS layer required"
        self.state = state
        self.spec = state.spec
        self.ocs = state.ocs
        # working copies
        self.circuits = [dict(c) for c in self.ocs.circuits]
        cap = self.ocs.capacity()
        self.spare = [[cap[n][m] - state.reserved(n, m)
                       for m in range(self.spec.num_spines)]
                      for n in range(self.spec.num_leafs)]
        self.moves: List[Tuple[int, int, int]] = []     # (k, leaf_port, spine_port)
        self.unwired: List[Tuple[int, int]] = []        # (k, leaf_port) — for xconn
        self._lports = [self.ocs.leaf_ports(k) for k in range(self.spec.num_ocs)]
        self._sports = [self.ocs.spine_ports(k) for k in range(self.spec.num_ocs)]

    # -- lookups over the working copy --------------------------------------
    def _endpoints(self, k: int):
        return self._lports[k], self._sports[k]

    def _movable_leaf_port(self, k: int, leaf: int,
                           avoid_spine: Optional[int] = None) -> Optional[int]:
        lports, sports = self._endpoints(k)
        taken = {(kk, pp) for (kk, pp, *_rest) in self.unwired}
        taken |= set(self.state.xconn_owner)
        for lp, (n, _) in enumerate(lports):
            if n != leaf or (k, lp) in taken:
                continue
            sp = self.circuits[k].get(lp)
            if sp is None:
                return lp  # unwired: free to use
            m, _ = sports[sp]
            if m == avoid_spine:
                continue  # already on the target spine — moving it is a no-op
            if self.spare[n][m] > 0:
                return lp
        return None

    def _free_spine_port(self, k: int, spine: int,
                         for_leaf: Optional[int] = None) -> Optional[int]:
        """A spine-side port on OCS k that is unwired (preferred — no
        eviction) or ends a movable circuit.  Never evicts a circuit from
        ``for_leaf`` itself — that would undo the channel being built."""
        lports, sports = self._endpoints(k)
        wired = {sp: lp for lp, sp in self.circuits[k].items()}
        evictable = None
        for sp, (m, _) in enumerate(sports):
            if m != spine:
                continue
            if sp not in wired:
                return sp
            if evictable is None:
                n2, _ = lports[wired[sp]]
                if n2 != for_leaf and self.spare[n2][spine] > 0:
                    evictable = sp
        return evictable

    # -- operations -----------------------------------------------------------
    def _headroom(self, k: int, leaf: int, spine: int) -> int:
        """How much slack OCS k has for a (leaf, spine) circuit: counts of
        movable leaf ports × available spine ports (0 when either missing)."""
        lports, sports = self._endpoints(k)
        taken = {(kk, pp) for (kk, pp, *_r) in self.unwired}
        taken |= set(self.state.xconn_owner)
        nl = 0
        for lp, (n, _) in enumerate(lports):
            if n != leaf or (k, lp) in taken:
                continue
            sp = self.circuits[k].get(lp)
            if sp is None:
                nl += 1
                continue
            m, _ = sports[sp]
            if m != spine and self.spare[n][m] > 0:
                nl += 1
        if nl == 0:
            return 0
        wired = {s_: l_ for l_, s_ in self.circuits[k].items()}
        ns = 0
        for sp, (m, _) in enumerate(sports):
            if m != spine:
                continue
            if sp not in wired:
                ns += 2  # unwired spine port: cheapest (no eviction)
                continue
            n2, _ = lports[wired[sp]]
            if n2 != leaf and self.spare[n2][spine] > 0:
                ns += 1
        return min(nl, ns) if ns else 0

    def add_channel(self, leaf: int, spine: int) -> bool:
        """Create one extra channel leaf→spine, choosing the OCS with the
        most remaining slack (load-balances circuits across OCSes so later
        demands don't starve)."""
        order = sorted(range(self.spec.num_ocs),
                       key=lambda k: -self._headroom(k, leaf, spine))
        for k in order:
            if self._headroom(k, leaf, spine) <= 0:
                break
            lp = self._movable_leaf_port(k, leaf, avoid_spine=spine)
            if lp is None:
                continue
            sp = self._free_spine_port(k, spine, for_leaf=leaf)
            if sp is None:
                continue
            lports, sports = self._endpoints(k)
            wired = {s_: l_ for l_, s_ in self.circuits[k].items()}
            # 1. detach lp from its old spine port (frees old channel)
            old_sp = self.circuits[k].pop(lp, None)
            if old_sp is not None:
                m_old, _ = sports[old_sp]
                n, _ = lports[lp]
                self.spare[n][m_old] -= 1  # channel disappears
            # 2. evict the circuit currently on sp, if any — rehome its leaf
            #    port onto lp's old spine port (classic 2-swap)
            if sp in wired and wired[sp] != lp:
                lp2 = wired[sp]
                n2, _ = lports[lp2]
                self.spare[n2][spine] -= 1
                del self.circuits[k][lp2]
                if old_sp is not None:
                    m_old, _ = sports[old_sp]
                    self.circuits[k][lp2] = old_sp
                    self.spare[n2][m_old] += 1
                    self.moves.append((k, lp2, old_sp))
            # 3. wire lp -> sp
            self.circuits[k][lp] = sp
            n, _ = lports[lp]
            self.spare[n][spine] += 1
            self.moves.append((k, lp, sp))
            return True
        return False

    def ensure(self, need: Dict[Tuple[int, int], int]) -> bool:
        """Create capacity so every (n, m) has ≥ need[n, m] spare channels.

        Pins created channels so later swaps cannot cannibalise them.
        Bounded by the total port count — a livelock guard, not a budget.
        """
        guard = 4 * self.spec.num_leafs * self.spec.uplinks_per_leaf
        for (n, m), cnt in sorted(need.items()):
            while self.spare[n][m] < cnt:
                guard -= 1
                if guard <= 0 or not self.add_channel(n, m):
                    return False
            self.spare[n][m] -= cnt  # pin
        return True

    def take_xconn(self, leaf_a: int, leaf_b: int, count: int) -> bool:
        """Unwire `count` movable ports on each of two leafs sharing an OCS
        and patch them pairwise (2-leaf direct case, zero spine ports).
        Original circuits are recorded so release can restore them."""
        done = 0
        for k in range(self.spec.num_ocs):
            while done < count:
                pa = self._movable_leaf_port(k, leaf_a)
                pb = self._movable_leaf_port(k, leaf_b)
                if pa is None or pb is None:
                    break  # need both endpoints on the same OCS
                for p in (pa, pb):
                    orig = self.circuits[k].get(p)
                    self._unwire(k, p)
                    self.unwired.append((k, p, -1 if orig is None else orig))
                done += 1
            if done >= count:
                return True
        return done >= count

    def _unwire(self, k: int, lp: int) -> None:
        sp = self.circuits[k].pop(lp, None)
        if sp is not None:
            lports, sports = self._endpoints(k)
            n, _ = lports[lp]
            m, _ = sports[sp]
            self.spare[n][m] -= 1

    def apply(self) -> None:
        """Write the planned circuit layout back to the live OCS."""
        self.ocs.circuits = [dict(c) for c in self.circuits]


# ---------------------------------------------------------------------------
# Stage 2: single spine (incl. 2-leaf direct)
# ---------------------------------------------------------------------------

def collect_idle_servers(state: FabricState, n_servers: int,
                         max_leafs: Optional[int] = None) -> Optional[List[int]]:
    """Pick idle servers best-fit across leafs (fewest idle servers first).
    Public building block for strategy plugins (docs/strategies.md)."""
    counts = state.idle_server_counts()
    by_leaf = sorted((int(c), n) for n, c in enumerate(counts.tolist()) if c)
    servers: List[int] = []
    leafs_used = 0
    for _, leaf in by_leaf:
        if max_leafs is not None and leafs_used >= max_leafs:
            break
        idle = state.idle_servers_of_leaf(leaf)
        take = min(len(idle), n_servers - len(servers))
        servers.extend(idle[:take])
        leafs_used += 1
        if len(servers) >= n_servers:
            return servers
    return None


# deprecated alias (pre-registry name)
_collect_servers = collect_idle_servers


def _stage2_single_spine(state: FabricState, job_id: int,
                         n: int) -> Optional[Placement]:
    spec = state.spec
    req_servers = math.ceil(n / spec.gpus_per_server)
    servers = collect_idle_servers(state, req_servers)
    if servers is None:
        return None
    leafs_cnt: Dict[int, int] = {}
    for sv in servers:
        leaf = spec.leaf_of_server(sv)
        leafs_cnt[leaf] = leafs_cnt.get(leaf, 0) + 1

    # --- 2-leaf direct OCS cross-connect (zero spine ports, Fig. 3) -------
    if len(leafs_cnt) == 2 and state.ocs is not None:
        (la, ca), (lb, cb) = sorted(leafs_cnt.items())
        circuits = min(ca, cb) * spec.gpus_per_server
        planner = RewirePlanner(state)
        if planner.take_xconn(la, lb, circuits):
            planner.apply()
            gpus = [g for sv in servers for g in spec.gpus_of_server(sv)][:n]
            vc = VirtualClos(leafs=[la, lb], spines=[], links={},
                             gpus_per_leaf=max(ca, cb) * spec.gpus_per_server)
            return Placement(job_id, gpus, "ocs-xconn", vclos=vc,
                             xconn_ports=list(planner.unwired))

    if state.ocs is None or len(leafs_cnt) < 2:
        return None
    # --- single spine: every cross-leaf GPU needs one channel to spine m ---
    # choose spine best-fit: fewest-but-enough free downlink channels
    cap = state.capacity()
    cands = []
    for m in range(spec.num_spines):
        free = state.spine_free_ports(m, cap)
        if free >= n:
            cands.append((free, m))
    if not cands:
        return None
    cands.sort()
    for _, m in cands:
        need = {(leaf, m): cnt * spec.gpus_per_server
                for leaf, cnt in leafs_cnt.items()}
        planner = RewirePlanner(state)
        if planner.ensure(need):
            planner.apply()
            gpus = [g for sv in servers for g in spec.gpus_of_server(sv)][:n]
            links = {k: v for k, v in need.items()}
            routing_maps: Dict[int, Dict[int, Tuple[int, int]]] = {}
            for leaf in leafs_cnt:
                rmap = {}
                for idx, g in enumerate(g for g in gpus
                                        if spec.leaf_of_gpu(g) == leaf):
                    rmap[spec.port_of_gpu(g)] = (m, idx)
                routing_maps[leaf] = rmap
            vc = VirtualClos(leafs=sorted(leafs_cnt), spines=[m], links=links,
                             gpus_per_leaf=max(leafs_cnt.values())
                             * spec.gpus_per_server)
            return Placement(job_id, gpus, "ocs-spine", vclos=vc,
                             routing_maps=routing_maps)
    return None


# ---------------------------------------------------------------------------
# Stage 3: OCSFINDCLOS
# ---------------------------------------------------------------------------

def _stage3_findclos(state: FabricState, job_id: int,
                     n: int) -> Optional[Placement]:
    spec = state.spec
    for size in candidate_sizes(n, spec):
        for l, s in _factorizations(size, spec):
            sol = _choose_leafs_spines_ocs(state, l, s)
            if sol is None:
                continue
            leaf_alloc, spines = sol
            need: Dict[Tuple[int, int], int] = {}
            for leaf, vleafs in leaf_alloc.items():
                for m in spines:
                    need[(leaf, m)] = need.get((leaf, m), 0) + vleafs
            planner = RewirePlanner(state)
            if not planner.ensure(need):
                continue
            planner.apply()
            return _materialize_ocs(state, job_id, n, leaf_alloc, spines, s,
                                    need, overalloc=size - n)
    return None


def _choose_leafs_spines_ocs(state: FabricState, l: int,
                             s: int) -> Optional[Tuple[Dict[int, int], List[int]]]:
    """Aggregated port-count selection (eqs. 7–11 with OCS index summed out).

    Multiple virtual leafs per physical leaf are allowed (the L_{n,a}
    linearisation): leaf n can host a_n = idle_servers·T // s virtual leafs.
    Feasibility is pure port counting; circuit realisation is checked by the
    RewirePlanner afterwards.
    """
    spec = state.spec
    req_servers_per_vleaf = s // spec.gpus_per_server
    # capacity of each leaf in virtual leafs, and free movable uplink ports
    avail: List[Tuple[int, int, int]] = []  # (idle_servers, leaf, max_vleafs)
    for leaf in range(spec.num_leafs):
        idle = len(state.idle_servers_of_leaf(leaf))
        free_up = state.leaf_free_ports_ocs(leaf)
        max_v = min(idle // req_servers_per_vleaf, free_up // s)
        if max_v > 0:
            avail.append((idle, leaf, max_v))
    if sum(a[2] for a in avail) < l:
        return None
    avail.sort()  # best-fit: fewest idle servers first
    leaf_alloc: Dict[int, int] = {}
    left = l
    for _, leaf, max_v in avail:
        take = min(max_v, left)
        if take:
            leaf_alloc[leaf] = take
            left -= take
        if not left:
            break
    if left:
        return None
    # spines: need l free downlink channels each; best-fit fewest free ports
    cap = state.capacity()
    cands = sorted((state.spine_free_ports(m, cap), m)
                   for m in range(spec.num_spines)
                   if state.spine_free_ports(m, cap) >= l)
    if len(cands) < s:
        return None
    return leaf_alloc, [m for _, m in cands[:s]]


def _materialize_ocs(state: FabricState, job_id: int, n_requested: int,
                     leaf_alloc: Dict[int, int], spines: List[int], s: int,
                     links: Dict[Tuple[int, int], int],
                     overalloc: int) -> Placement:
    spec = state.spec
    req_servers_per_vleaf = s // spec.gpus_per_server
    gpus: List[int] = []
    routing_maps: Dict[int, Dict[int, Tuple[int, int]]] = {}
    leaf_order: List[int] = []
    for leaf, vleafs in sorted(leaf_alloc.items()):
        servers = state.idle_servers_of_leaf(leaf)[:vleafs * req_servers_per_vleaf]
        leaf_gpus = [g for sv in servers for g in spec.gpus_of_server(sv)]
        gpus.extend(leaf_gpus)
        rmap: Dict[int, Tuple[int, int]] = {}
        for idx, g in enumerate(leaf_gpus):
            rmap[spec.port_of_gpu(g)] = (spines[idx % len(spines)], 0)
        routing_maps[leaf] = rmap
        leaf_order.extend([leaf] * vleafs)
    vclos = VirtualClos(leafs=leaf_order, spines=list(spines),
                        links=dict(links), gpus_per_leaf=s)
    return Placement(job_id,
                     gpus if overalloc else gpus[:n_requested],
                     "ocs-vclos", vclos=vclos, routing_maps=routing_maps,
                     overallocated=overalloc)


# ---------------------------------------------------------------------------
# Release: restore xconn-unwired ports into the leaf-spine fabric
# ---------------------------------------------------------------------------

def ocs_release(state: FabricState, placement: Placement) -> None:
    """Release a job placed by OCS-vClos; rewires xconn ports back onto their
    original spine-side ports (falling back to any free port) so fabric
    capacity is not lost, then renormalises drifted circuits."""
    state.release_job(placement.job_id)
    if state.ocs is None:
        return
    ocs = state.ocs
    for k, lp, orig_sp in placement.xconn_ports:
        state.xconn_owner.pop((k, lp), None)
        if lp in ocs.circuits[k]:
            continue
        used = set(ocs.circuits[k].values())
        if orig_sp >= 0 and orig_sp not in used:
            ocs.circuits[k][lp] = orig_sp
        else:
            nports = len(ocs.spine_ports(k))
            free_sp = next((sp for sp in range(nports) if sp not in used), None)
            if free_sp is not None:
                ocs.circuits[k][lp] = free_sp
    renormalize(state)


def renormalize(state: FabricState, max_moves: int = 64) -> None:
    """Drift control: swap *idle* circuits back toward the uniform Latin
    wiring (leaf n port j -> spine (j+n) mod S).  Mirrors Minimal-Rewiring
    [59]-style background reconfiguration; only unreserved channels move."""
    if state.ocs is None:
        return
    spec, ocs = state.spec, state.ocs
    cap = state.capacity()
    spare = [[cap[n][m] - state.reserved(n, m) for m in range(spec.num_spines)]
             for n in range(spec.num_leafs)]
    moves = 0
    for k in range(spec.num_ocs):
        lports = ocs.leaf_ports(k)
        sports = ocs.spine_ports(k)
        sp_by_spine: Dict[int, List[int]] = {}
        for sp, (m, _) in enumerate(sports):
            sp_by_spine.setdefault(m, []).append(sp)
        used = set(ocs.circuits[k].values())
        wired = {sp: lp for lp, sp in ocs.circuits[k].items()}
        for lp, (n, j) in enumerate(lports):
            if moves >= max_moves:
                return
            if (k, lp) in state.xconn_owner:
                continue  # live cross-connect patch — never touch
            target_m = (j + n) % spec.num_spines
            cur_sp = ocs.circuits[k].get(lp)
            if cur_sp is not None:
                m_cur, _ = sports[cur_sp]
                if m_cur == target_m or spare[n][m_cur] <= 0:
                    continue
            free_target = next((sp for sp in sp_by_spine.get(target_m, [])
                                if sp not in used), None)
            if free_target is None:
                # 2-swap: evict a movable circuit off a target-spine port
                for sp_t in sp_by_spine.get(target_m, []):
                    lp2 = wired.get(sp_t)
                    if lp2 is None or lp2 == lp or (k, lp2) in state.xconn_owner:
                        continue
                    n2, _ = lports[lp2]
                    if n2 == n or spare[n2][target_m] <= 0 or cur_sp is None:
                        continue
                    # swap spine ports of lp and lp2
                    m_cur, _ = sports[cur_sp]
                    ocs.circuits[k][lp] = sp_t
                    ocs.circuits[k][lp2] = cur_sp
                    wired[sp_t] = lp
                    wired[cur_sp] = lp2
                    spare[n][m_cur] -= 1
                    spare[n][target_m] += 1
                    spare[n2][target_m] -= 1
                    spare[n2][m_cur] += 1
                    moves += 1
                    break
                continue
            if cur_sp is not None:
                m_cur, _ = sports[cur_sp]
                used.discard(cur_sp)
                wired.pop(cur_sp, None)
                spare[n][m_cur] -= 1
            ocs.circuits[k][lp] = free_target
            used.add(free_target)
            wired[free_target] = lp
            spare[n][target_m] += 1
            moves += 1


# ---------------------------------------------------------------------------
# Top-level (Algorithm 2)
# ---------------------------------------------------------------------------

def ocs_vclos_place(state: FabricState, job_id: int, n: int):
    spec = state.spec
    if n <= spec.gpus_per_server:
        p = stage0_server(state, job_id, n)
        return p if p else PlacementFailure("gpu")
    p = stage1_leaf(state, job_id, n)
    if p is not None:
        return p
    p = _stage2_single_spine(state, job_id, n)
    if p is not None:
        return p
    p = _stage3_findclos(state, job_id, n)
    if p is not None:
        return p
    idle_servers = sum(1 for sv in range(spec.num_servers) if state.server_idle(sv))
    need = math.ceil(n / spec.gpus_per_server)
    return PlacementFailure("network" if idle_servers >= need else "gpu")
