"""Leaf-Spine (folded-Clos) fabric model with optional OCS layer.

This is the physical substrate of the paper (Fig. 4): ``L`` leaf switches,
``S`` spine switches, ``gpus_per_leaf`` server-facing ports per leaf (one NIC
per GPU, as in EFLOPS), and a uniform bipartite graph between leafs and
spines.  Each server hosts ``gpus_per_server`` GPUs connected internally by
NVLink/ICI (contention-free by construction).

Directional fabric links:
  * uplink   ``(leaf n, spine m, channel c)`` — leaf-to-spine
  * downlink ``(spine m, leaf n, channel c)`` — spine-to-leaf

``vClos`` reserves (leaf, spine) channels exclusively per job; the OCS layer
(``OCSLayer``) rewires *idle* leaf uplink ports to spine downlink ports,
changing the effective capacity matrix ``C[n][m]`` (paper §7, Table 1).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

Link = Tuple[str, int, int, int]  # ("up"|"down", leaf, spine, channel)


@dataclass(frozen=True)
class ClusterSpec:
    """Static description of a Leaf-Spine GPU cluster.

    Defaults follow the paper's CLUSTER512: 64-port switches, 16 leafs with
    32 server-facing + 32 spine-facing ports each, 32 spines, 8 GPUs/server.
    """

    num_leafs: int = 16
    num_spines: int = 32
    gpus_per_leaf: int = 32
    gpus_per_server: int = 8
    link_gbps: float = 100.0
    # extra uplink channels per (leaf, spine) pair
    channels: int = 1
    # uplink multiplier — rECMP's "+50% leaf-spine links" uses 1.5 together
    # with 1.5x num_spines (Table 4 "Redundance" baseline)
    uplink_factor: float = 1.0
    num_ocs: int = 0  # 0 → static electrical fabric
    # -- heterogeneous fabric (docs/heterogeneous.md) ----------------------
    # Per-tier link speeds: None (default) keeps the homogeneous fabric
    # where every tier runs at link_gbps.  Setting either field — even to
    # link_gbps itself — opts the spec into the speed-aware rate
    # resolution path (``is_hetero``), whose degenerate case is proven
    # byte-identical to the homogeneous arithmetic (tests/test_hetero.py).
    leaf_uplink_gbps: Optional[float] = None   # leaf↔spine fabric tier
    server_nic_gbps: Optional[float] = None    # server NIC tier
    # Per-server GPU generation: relative compute scale (1.0 = the
    # reference generation; 2.0 = twice as fast) and an optional name tag
    # per server.  A job's compute time scales by its *slowest* member
    # (straggler model).  Length must equal num_servers.
    server_scale: Optional[Tuple[float, ...]] = None
    server_gen: Optional[Tuple[str, ...]] = None

    def __post_init__(self) -> None:
        if self.gpus_per_leaf % self.gpus_per_server:
            raise ValueError("gpus_per_leaf must be a multiple of gpus_per_server")
        if self.uplinks_per_leaf % self.num_spines:
            raise ValueError("uplinks must divide evenly across spines")
        if self.num_ocs:
            up = self.uplinks_per_leaf
            down = self.downlinks_per_spine
            if up % self.num_ocs or down % self.num_ocs:
                raise ValueError("num_ocs must divide per-leaf uplinks and per-spine downlinks")
        for name in ("leaf_uplink_gbps", "server_nic_gbps"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, (int, float))
                                  or not v > 0):
                raise ValueError(
                    f"{name} must be a positive speed in Gbps (got {v!r}); "
                    f"leave it None for the homogeneous {self.link_gbps:g}G "
                    f"fabric")
        if self.server_scale is not None:
            if len(self.server_scale) != self.num_servers:
                raise ValueError(
                    f"server_scale needs one entry per server "
                    f"(got {len(self.server_scale)}, cluster has "
                    f"{self.num_servers}); use apply_gpu_mix() to expand a "
                    f"generation mix into per-server scales")
            for i, s in enumerate(self.server_scale):
                if not isinstance(s, (int, float)) or not s > 0:
                    raise ValueError(
                        f"server_scale[{i}] must be a positive relative "
                        f"compute scale (got {s!r}); 1.0 is the reference "
                        f"generation")
        if self.server_gen is not None:
            if self.server_scale is None:
                raise ValueError(
                    "server_gen tags need matching server_scale values; "
                    "pass both (apply_gpu_mix() builds the pair)")
            if len(self.server_gen) != self.num_servers:
                raise ValueError(
                    f"server_gen needs one tag per server "
                    f"(got {len(self.server_gen)}, cluster has "
                    f"{self.num_servers})")

    # -- derived sizes ---------------------------------------------------
    @property
    def num_gpus(self) -> int:
        return self.num_leafs * self.gpus_per_leaf

    @property
    def num_servers(self) -> int:
        return self.num_gpus // self.gpus_per_server

    @property
    def servers_per_leaf(self) -> int:
        return self.gpus_per_leaf // self.gpus_per_server

    @property
    def uplinks_per_leaf(self) -> int:
        return int(self.gpus_per_leaf * self.channels * self.uplink_factor)

    @property
    def downlinks_per_spine(self) -> int:
        return self.num_leafs * self.uplinks_per_leaf // self.num_spines

    @property
    def base_channels(self) -> int:
        """Links between every (leaf, spine) pair in the uniform wiring."""
        return self.uplinks_per_leaf // self.num_spines

    # -- heterogeneous-fabric views (docs/heterogeneous.md) ----------------
    @property
    def is_hetero(self) -> bool:
        """Whether the spec opts into speed-aware rate resolution.  Any
        hetero field explicitly set — even to its homogeneous value —
        counts: the degenerate arithmetic is byte-identical, so explicit
        1.0-ratio specs exercise the hetero path while reproducing the
        homogeneous schedules exactly (tests/test_hetero.py)."""
        return (self.leaf_uplink_gbps is not None
                or self.server_nic_gbps is not None
                or self.server_scale is not None)

    @property
    def leaf_ratio(self) -> float:
        """Leaf↔spine tier speed relative to the reference link_gbps."""
        if self.leaf_uplink_gbps is None:
            return 1.0
        return self.leaf_uplink_gbps / self.link_gbps

    @property
    def nic_ratio(self) -> float:
        """Server-NIC tier speed relative to the reference link_gbps."""
        if self.server_nic_gbps is None:
            return 1.0
        return self.server_nic_gbps / self.link_gbps

    def scale_of_server(self, server: int) -> float:
        """Relative compute scale of ``server`` (1.0 when homogeneous)."""
        if self.server_scale is None:
            return 1.0
        return self.server_scale[server]

    # -- id mapping --------------------------------------------------------
    def leaf_of_gpu(self, gpu: int) -> int:
        return gpu // self.gpus_per_leaf

    def server_of_gpu(self, gpu: int) -> int:
        return gpu // self.gpus_per_server

    def leaf_of_server(self, server: int) -> int:
        return server * self.gpus_per_server // self.gpus_per_leaf

    def port_of_gpu(self, gpu: int) -> int:
        """Server-facing port index of ``gpu`` on its leaf."""
        return gpu % self.gpus_per_leaf

    def gpus_of_server(self, server: int) -> List[int]:
        t = self.gpus_per_server
        return list(range(server * t, (server + 1) * t))

    def servers_of_leaf(self, leaf: int) -> List[int]:
        spl = self.servers_per_leaf
        return list(range(leaf * spl, (leaf + 1) * spl))


# Paper cluster presets -----------------------------------------------------
CLUSTER512 = ClusterSpec(num_leafs=16, num_spines=32, gpus_per_leaf=32,
                         gpus_per_server=8, num_ocs=0)
CLUSTER512_OCS = dataclasses.replace(CLUSTER512, num_ocs=16)
CLUSTER2048 = ClusterSpec(num_leafs=64, num_spines=32, gpus_per_leaf=32,
                          gpus_per_server=8, num_ocs=0)
CLUSTER2048_OCS = dataclasses.replace(CLUSTER2048, num_ocs=32)
# Testbed (§8.1): 8 servers x 4 GPUs; the paper virtualises its four
# CE8850 switches via VRF ("one Spine switch virtualized into four logical
# Spine switches") — we model the resulting logical fabric: 4 leafs x 8
# logical spines, 2 servers per leaf.
TESTBED32 = ClusterSpec(num_leafs=4, num_spines=8, gpus_per_leaf=8,
                        gpus_per_server=4, channels=1, num_ocs=0)


def apply_gpu_mix(spec: ClusterSpec,
                  mix: List[Tuple[str, float, float]]) -> ClusterSpec:
    """Expand a GPU-generation mix into per-server tags/scales on ``spec``.

    ``mix`` is ``[(generation_name, compute_scale, fraction), ...]``;
    fractions must be positive and sum to 1.  Servers are assigned in
    contiguous id blocks, in the listed order, with the *last* generation
    absorbing the rounding remainder — a deterministic layout so two specs
    built from the same mix are equal (and campaign cells reproducible).
    """
    if not mix:
        raise ValueError("gpu mix is empty; pass at least one "
                         "(name, scale, fraction) entry")
    for name, scale, frac in mix:
        if not isinstance(scale, (int, float)) or not scale > 0:
            raise ValueError(f"gpu mix {name!r}: compute scale must be "
                             f"positive (got {scale!r})")
        if not isinstance(frac, (int, float)) or not frac > 0:
            raise ValueError(f"gpu mix {name!r}: fraction must be "
                             f"positive (got {frac!r})")
    total = math.fsum(f for _, _, f in mix)
    if abs(total - 1.0) > 1e-9:
        raise ValueError(f"gpu mix fractions must sum to 1 "
                         f"(got {total:g}); scale them or drop an entry")
    n = spec.num_servers
    counts = [int(f * n) for _, _, f in mix]
    counts[-1] += n - sum(counts)          # remainder to the last entry
    if counts[-1] <= 0:
        raise ValueError(f"gpu mix leaves no servers for "
                         f"{mix[-1][0]!r} on a {n}-server cluster; use "
                         f"coarser fractions")
    gens: List[str] = []
    scales: List[float] = []
    for (name, scale, _), cnt in zip(mix, counts):
        gens += [name] * cnt
        scales += [float(scale)] * cnt
    return dataclasses.replace(spec, server_gen=tuple(gens),
                               server_scale=tuple(scales))


@dataclass
class OCSLayer:
    """MEMS optical-circuit-switch layer between leafs and spines (§7).

    OCS ``k`` owns leaf-side ports ``(n, j)`` for uplink indices
    ``j ≡ k (mod K)`` and spine-side ports ``(m, i)`` for downlink indices
    ``i ≡ k (mod K)``.  A *circuit* pairs one leaf-side port with one
    spine-side port on the same OCS.  Only circuits whose link is idle may be
    rewired (50 ms switch time ⇒ never touch live traffic).
    """

    spec: ClusterSpec
    # circuits[k]: dict leaf_port -> spine_port, both local to OCS k
    circuits: List[Dict[int, int]] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.circuits:
            self.circuits = [dict() for _ in range(self.spec.num_ocs)]
            self._wire_uniform()

    # Port bookkeeping: leaf-side port local id on OCS k enumerates
    # (leaf, uplink j) pairs with j % K == k, ordered by (leaf, j).
    def leaf_ports(self, k: int) -> List[Tuple[int, int]]:
        s = self.spec
        return [(n, j) for n in range(s.num_leafs)
                for j in range(k, s.uplinks_per_leaf, s.num_ocs)]

    def spine_ports(self, k: int) -> List[Tuple[int, int]]:
        s = self.spec
        return [(m, i) for m in range(s.num_spines)
                for i in range(k, s.downlinks_per_spine, s.num_ocs)]

    def _wire_uniform(self) -> None:
        """Default wiring realising the uniform bipartite graph.

        Latin-square assignment: uplink ``j`` of leaf ``n`` targets spine
        ``(j + n) mod S``.  Per leaf this covers every spine ``U/S`` times
        (uniform), and per OCS the targets form a perfect matching onto the
        OCS's spine-side ports for the preset cluster shapes.
        """
        s = self.spec
        for k in range(s.num_ocs):
            lports = self.leaf_ports(k)
            sports = self.spine_ports(k)
            free = {m: [idx for idx, (mm, _) in enumerate(sports) if mm == m]
                    for m in range(s.num_spines)}
            for lp, (n, j) in enumerate(lports):
                m = (j + n) % s.num_spines
                if not free[m]:
                    # fall back to any spine with a free port on this OCS
                    m = next(mm for mm in range(s.num_spines) if free[mm])
                self.circuits[k][lp] = free[m].pop(0)

    def capacity(self) -> List[List[int]]:
        """Effective link-count matrix C[n][m] induced by current circuits."""
        s = self.spec
        cap = [[0] * s.num_spines for _ in range(s.num_leafs)]
        for k in range(s.num_ocs):
            lports = self.leaf_ports(k)
            sports = self.spine_ports(k)
            for lp, sp in self.circuits[k].items():
                n, _ = lports[lp]
                m, _ = sports[sp]
                cap[n][m] += 1
        return cap


@dataclass
class FabricState:
    """Mutable occupancy state of a cluster: GPUs, links, OCS circuits."""

    spec: ClusterSpec
    ocs: Optional[OCSLayer] = None
    # gpu -> job_id (absent = free)
    gpu_owner: Dict[int, int] = field(default_factory=dict)
    # reserved channel counts per (leaf, spine) -> job_id -> count
    link_owner: Dict[Tuple[int, int], Dict[int, int]] = field(default_factory=dict)
    # OCS leaf ports held by live leaf↔leaf cross-connects: (ocs, port) -> job
    xconn_owner: Dict[Tuple[int, int], int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.spec.num_ocs and self.ocs is None:
            self.ocs = OCSLayer(self.spec)
        self._rebuild_occupancy()

    def _rebuild_occupancy(self) -> None:
        """Recompute the per-server free-GPU counts from ``gpu_owner``.
        Must be called after replacing ``gpu_owner`` wholesale (snapshot);
        allocate/release maintain the counts incrementally."""
        t = self.spec.gpus_per_server
        self._server_free = [t] * self.spec.num_servers
        for g in self.gpu_owner:
            self._server_free[self.spec.server_of_gpu(g)] -= 1
        self._free_snapshot = None

    def server_free_array(self):
        """Per-server idle-GPU counts as a numpy snapshot (placement fast
        paths; the counts themselves stay a list for O(1) scalar updates).
        Cached between mutations — repeated placement attempts against an
        unchanged fabric reuse one snapshot."""
        if self._free_snapshot is None:
            self._free_snapshot = np.fromiter(self._server_free,
                                              dtype=np.int64,
                                              count=self.spec.num_servers)
        return self._free_snapshot

    def idle_server_counts(self):
        """Per-leaf count of fully-idle servers as a numpy array."""
        arr = self.server_free_array()
        idle = arr == self.spec.gpus_per_server
        return idle.reshape(self.spec.num_leafs,
                            self.spec.servers_per_leaf).sum(axis=1)

    # -- capacity ----------------------------------------------------------
    def capacity(self) -> List[List[int]]:
        if self.ocs is not None:
            return self.ocs.capacity()
        s = self.spec
        return [[s.base_channels] * s.num_spines for _ in range(s.num_leafs)]

    def reserved(self, n: int, m: int) -> int:
        return sum(self.link_owner.get((n, m), {}).values())

    def free_channels(self, n: int, m: int, cap: Optional[List[List[int]]] = None) -> int:
        c = (cap or self.capacity())[n][m]
        return c - self.reserved(n, m)

    def free_capacity(self) -> List[List[int]]:
        cap = self.capacity()
        s = self.spec
        return [[cap[n][m] - self.reserved(n, m) for m in range(s.num_spines)]
                for n in range(s.num_leafs)]

    # -- GPU / server occupancy ---------------------------------------------
    def gpu_free(self, gpu: int) -> bool:
        return gpu not in self.gpu_owner

    def server_free_gpus(self, server: int) -> int:
        """O(1) count of idle GPUs on ``server``."""
        return self._server_free[server]

    def idle_gpus_of_server(self, server: int) -> List[int]:
        free = self._server_free[server]
        if free == 0:
            return []
        if free == self.spec.gpus_per_server:
            return self.spec.gpus_of_server(server)
        return [g for g in self.spec.gpus_of_server(server) if self.gpu_free(g)]

    def server_idle(self, server: int) -> bool:
        return self._server_free[server] == self.spec.gpus_per_server

    def idle_servers_of_leaf(self, leaf: int) -> List[int]:
        return [sv for sv in self.spec.servers_of_leaf(leaf) if self.server_idle(sv)]

    def num_free_gpus(self) -> int:
        return self.spec.num_gpus - len(self.gpu_owner)

    def spine_free_ports(self, m: int, cap: Optional[List[List[int]]] = None) -> int:
        """RPN(S_m): unreserved downlink channels of spine m (paper eq. 6)."""
        c = cap or self.capacity()
        return sum(c[n][m] - self.reserved(n, m) for n in range(self.spec.num_leafs))

    def leaf_free_uplinks(self, n: int, cap: Optional[List[List[int]]] = None) -> int:
        c = cap or self.capacity()
        return sum(c[n][m] - self.reserved(n, m) for m in range(self.spec.num_spines))

    def leaf_free_ports_ocs(self, n: int) -> int:
        """Rewirable uplink-port budget of leaf n under an OCS fabric:
        physical ports − reserved channels − live xconn patches.  Unlike
        :meth:`leaf_free_uplinks` this counts currently-unwired ports too —
        the OCS can always wire them somewhere."""
        if self.ocs is None:
            return self.leaf_free_uplinks(n)
        held = 0
        for k in range(self.spec.num_ocs):
            lports = self.ocs.leaf_ports(k)
            held += sum(1 for (kk, lp) in self.xconn_owner
                        if kk == k and lports[lp][0] == n)
        reserved = sum(self.reserved(n, m) for m in range(self.spec.num_spines))
        return self.spec.uplinks_per_leaf - reserved - held

    # -- mutation ------------------------------------------------------------
    def allocate_gpus(self, job_id: int, gpus: List[int]) -> None:
        owner, free, t = self.gpu_owner, self._server_free, self.spec.gpus_per_server
        self._free_snapshot = None
        for g in gpus:
            if g in owner:
                raise ValueError(f"GPU {g} already owned by job {owner[g]}")
            owner[g] = job_id
            free[g // t] -= 1

    def reserve_links(self, job_id: int, links: Dict[Tuple[int, int], int]) -> None:
        cap = self.capacity()
        for (n, m), cnt in links.items():
            if cnt <= 0:
                continue
            if self.free_channels(n, m, cap) < cnt:
                raise ValueError(f"link ({n},{m}) over-reserved")
            self.link_owner.setdefault((n, m), {})[job_id] = (
                self.link_owner.get((n, m), {}).get(job_id, 0) + cnt)

    def release_job(self, job_id: int,
                    gpus: Optional[List[int]] = None) -> None:
        """Free a job's GPUs and link reservations.  Passing the job's GPU
        list (known from its Placement) releases in O(|gpus|) instead of
        scanning every allocated GPU; both paths leave identical state."""
        self._free_snapshot = None
        if gpus is not None:
            owner, free, t = self.gpu_owner, self._server_free, \
                self.spec.gpus_per_server
            for g in gpus:
                if owner.get(g) == job_id:
                    del owner[g]
                    free[g // t] += 1
        else:
            for g, j in self.gpu_owner.items():
                if j == job_id:
                    self._server_free[self.spec.server_of_gpu(g)] += 1
            self.gpu_owner = {g: j for g, j in self.gpu_owner.items()
                              if j != job_id}
        for key in list(self.link_owner):
            self.link_owner[key].pop(job_id, None)
            if not self.link_owner[key]:
                del self.link_owner[key]

    def unreserve_links(self, job_id: int,
                        links: Dict[Tuple[int, int], int]) -> None:
        """Return ``links`` channels reserved by ``job_id`` — the targeted
        inverse of :meth:`reserve_links`.  Unlike :meth:`release_job` this
        touches only the named (leaf, spine) pairs, so one owner (e.g. the
        link-failure fence) can release a single link while keeping its
        other holdings."""
        for (n, m), cnt in links.items():
            if cnt <= 0:
                continue
            held = self.link_owner.get((n, m), {})
            have = held.get(job_id, 0)
            if have < cnt:
                raise ValueError(f"job {job_id} holds {have} channels on "
                                 f"link ({n},{m}), cannot release {cnt}")
            if have == cnt:
                del held[job_id]
            else:
                held[job_id] = have - cnt
            if not held:
                self.link_owner.pop((n, m), None)

    # -- OCS rewiring ----------------------------------------------------------
    def rewire(self, moves: List[Tuple[int, int, int]]) -> None:
        """Apply OCS circuit moves ``(ocs_k, leaf_port, new_spine_port)``.

        Only idle circuits may move: a circuit is idle when the (leaf, spine)
        channel it currently realises has spare (unreserved) capacity.
        """
        if self.ocs is None:
            raise ValueError("no OCS layer on this fabric")
        for k, lp, new_sp in moves:
            lports = self.ocs.leaf_ports(k)
            sports = self.ocs.spine_ports(k)
            n, _ = lports[lp]
            cap = self.capacity()
            if lp in self.ocs.circuits[k]:
                old_sp = self.ocs.circuits[k][lp]
                m_old, _ = sports[old_sp]
                if cap[n][m_old] - self.reserved(n, m_old) <= 0:
                    raise ValueError(
                        f"OCS {k}: circuit leaf-port {lp} carries reserved traffic")
            if new_sp in self.ocs.circuits[k].values():
                raise ValueError(f"OCS {k}: spine port {new_sp} already wired")
            self.ocs.circuits[k][lp] = new_sp

    def snapshot(self) -> "FabricState":
        st = FabricState(self.spec, ocs=None)
        st.gpu_owner = dict(self.gpu_owner)
        st.link_owner = {k: dict(v) for k, v in self.link_owner.items()}
        st.xconn_owner = dict(self.xconn_owner)
        st._rebuild_occupancy()
        if self.ocs is not None:
            st.ocs = OCSLayer(self.spec, circuits=[dict(c) for c in self.ocs.circuits])
        return st
