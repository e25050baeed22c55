"""Routing strategies and per-link contention accounting (paper §5.2, §8.1).

Routes are sequences of *directional* fabric links:

  * intra-server flows traverse NVLink/ICI only (empty route — never contends)
  * intra-leaf flows traverse the leaf switch only (non-blocking — empty route)
  * inter-leaf flows traverse one uplink ``("up", leaf, spine, ch)`` and one
    downlink ``("down", spine, leaf_dst, ch)``

``SourceRouting`` implements the paper's static per-leaf map
``f_m: server-port -> uplink`` (§5.2); ``ECMPRouting`` hashes a 5-tuple proxy
(mmh3-style 64-bit mixer) per flow; ``BalancedECMPRouting`` picks the least
loaded uplink at flow-start (the paper's "Balanced" baseline, §9.3);
``IdealRouting`` models the single-big-switch ``Best`` upper bound.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .topology import ClusterSpec, Link
from .traffic import Flow, Phase


# ---------------------------------------------------------------------------
# hashing (ECMP)
# ---------------------------------------------------------------------------

def _mix64(x: int) -> int:
    """mmh3/splitmix-style 64-bit finalizer — stands in for the switch's
    undisclosed hash (§8.1 chooses mmh3 over the 5-tuple)."""
    x &= (1 << 64) - 1
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & ((1 << 64) - 1)
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & ((1 << 64) - 1)
    x ^= x >> 33
    return x


def ecmp_hash(src: int, dst: int, flow_id: int, seed: int, nway: int) -> int:
    """Hash of the flow 5-tuple proxy (src-ip, dst-ip, ports ~ flow_id)."""
    h = _mix64((src << 40) ^ (dst << 18) ^ (flow_id << 1) ^ _mix64(seed))
    return h % nway


def _mix64_vec(x: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_mix64` over a uint64 array.  Unlike the scalar
    path, uint64 *array* multiplies wrap silently in numpy — no errstate
    guard needed (and the per-call context-manager cost is measurable on
    the simulator's hot path)."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


def ecmp_hash_vec(src: np.ndarray, dst: np.ndarray, flow_id: int, seed: int,
                  nway: int) -> np.ndarray:
    """Vectorized :func:`ecmp_hash`; bit-identical to the scalar version."""
    x = ((src.astype(np.uint64) << np.uint64(40))
         ^ (dst.astype(np.uint64) << np.uint64(18))
         ^ np.uint64((flow_id << 1) & ((1 << 64) - 1))
         ^ np.uint64(_mix64(seed)))
    return (_mix64_vec(x) % np.uint64(nway)).astype(np.int64)


# int encoding of a directional link for numpy counting:
#   (((a << 12) | b) << 11 | channel) << 1 | is_down
# good for ≤4096 leafs/spines and ≤2048 channels.
def _decode_link(v: int) -> Link:
    down = v & 1
    v >>= 1
    ch = v & 0x7FF
    v >>= 11
    b = v & 0xFFF
    a = v >> 12
    return ("down" if down else "up", a, b, ch)


def _decode_link_counts(codes: np.ndarray, counts: np.ndarray) -> Counter:
    out: Counter = Counter()
    for v, c in zip(codes.tolist(), counts.tolist()):
        out[_decode_link(v)] = int(c)
    return out


def _encode_links(up_leaf: np.ndarray, up_spine: np.ndarray,
                  up_ch: np.ndarray, down_spine: np.ndarray,
                  down_leaf: np.ndarray, down_ch: np.ndarray) -> np.ndarray:
    upcode = ((((up_leaf << 12) | up_spine) << 11 | up_ch) << 1)
    dncode = ((((down_spine << 12) | down_leaf) << 11 | down_ch) << 1) | 1
    return np.concatenate([upcode, dncode])


# ---------------------------------------------------------------------------
# Dense link interning (the v2 engine's array-backed link state)
# ---------------------------------------------------------------------------

class LinkSpace:
    """Bijection between directional :data:`Link` tuples and dense integer
    ids ``[0, nlinks)`` so the simulator can keep link load / per-phase flow
    counts in flat numpy arrays instead of Counters.

    Layout (arithmetic, no lookup tables):
      * uplink  ``("up", leaf, spine, ch)``  -> ``(leaf·S + spine)·C + ch``
      * downlink ``("down", spine, leaf, ch)`` -> ``half + (spine·L + leaf)·C + ch``
    with ``C = uplinks_per_leaf // num_spines`` (the widest channel index any
    routing emits) and ``half = L·S·C``.
    """

    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        self.channels = max(1, spec.uplinks_per_leaf // spec.num_spines)
        self.half = spec.num_leafs * spec.num_spines * self.channels
        self.nlinks = 2 * self.half

    def id_of(self, link: Link) -> int:
        """Dense id of one link tuple (scalar fallback paths)."""
        kind, a, b, ch = link
        if kind == "up":
            return (a * self.spec.num_spines + b) * self.channels + ch
        return self.half + (a * self.spec.num_leafs + b) * self.channels + ch

    def ids_of_codes(self, codes: np.ndarray) -> np.ndarray:
        """Vectorized 36-bit link codes (``_encode_links``) -> dense ids."""
        down = codes & 1
        v = codes >> 1
        ch = v & 0x7FF
        v >>= 11
        b = v & 0xFFF
        a = v >> 12
        s = self.spec
        up_id = (a * s.num_spines + b) * self.channels + ch
        dn_id = self.half + (a * s.num_leafs + b) * self.channels + ch
        return np.where(down == 1, dn_id, up_id)


def multi_phase_dense_counts(routing: Routing, ls: LinkSpace,
                             src: np.ndarray, dst: np.ndarray,
                             phase_idx: np.ndarray, num_phases: int,
                             flow_id: int = 0) -> Optional[np.ndarray]:
    """Dense twin of :func:`multi_phase_link_counts`: per-phase per-link flow
    counts as one ``(num_phases, nlinks)`` int64 matrix (``None`` when
    ``routing`` has no vectorized path). bincount-based — no sort, no
    Counter materialisation."""
    res = routing._vec_dense_ids(src, dst, flow_id, ls)
    if res is None:
        return None
    m, up_ids, dn_ids = res
    out_shape = (num_phases, ls.nlinks)
    if not len(up_ids):
        return np.zeros(out_shape, dtype=np.int64)
    if num_phases == 1:     # ring AR etc: skip the phase-offset arithmetic
        flat = np.bincount(np.concatenate([up_ids, dn_ids]),
                           minlength=ls.nlinks)
    else:
        ph = phase_idx[m] * ls.nlinks
        flat = np.bincount(np.concatenate([ph + up_ids, ph + dn_ids]),
                           minlength=num_phases * ls.nlinks)
    return flat.reshape(out_shape)


def a2a_step_flows(ranks: Sequence[int]):
    """Flow arrays of every pairwise-AlltoAll step (step t: rank i →
    rank (i+t+1) mod N), as ``(src, dst, step_idx)`` — the single source
    of truth for the step pattern; :func:`traffic.pairwise_alltoall` is
    its Flow-object twin.  Both engines' builders and the count helpers
    below must use this so the v1≡v2 bit-parity contract cannot be broken
    by one copy drifting."""
    n = len(ranks)
    r = np.asarray(ranks, dtype=np.int64)
    if n < 2:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty, empty
    src = np.tile(r, n - 1)
    dst = r[(np.arange(1, n)[:, None] + np.arange(n)[None, :]) % n].ravel()
    step = np.repeat(np.arange(n - 1, dtype=np.int64), n)
    return src, dst, step


def alltoall_dense_counts(routing: Routing, ls: LinkSpace,
                          ranks: Sequence[int],
                          flow_id: int = 0,
                          aggregate: bool = True) -> Optional[np.ndarray]:
    """Dense twin of :func:`alltoall_link_counts`: per-link worst-case flow
    counts over the N-1 pairwise AlltoAll steps as a ``(nlinks,)`` array
    (``aggregate=True``), or the per-step ``(N-1, nlinks)`` count matrix
    (``aggregate=False``). ``None`` when no vectorized path exists."""
    n = len(ranks)
    if n < 2:
        return (np.zeros(ls.nlinks, dtype=np.int64) if aggregate
                else np.zeros((0, ls.nlinks), dtype=np.int64))
    src, dst, step = a2a_step_flows(ranks)
    per_step = multi_phase_dense_counts(routing, ls, src, dst, step, n - 1,
                                        flow_id)
    if per_step is None:
        return None
    return per_step.max(axis=0) if aggregate else per_step


# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------

class Routing:
    """Base: maps a flow to its directional fabric links."""

    def __init__(self, spec: ClusterSpec):
        self.spec = spec

    def route(self, flow: Flow, flow_id: int = 0) -> List[Link]:
        raise NotImplementedError

    def route_phase(self, phase: Phase) -> List[List[Link]]:
        return [self.route(f, i) for i, f in enumerate(phase)]

    # -- vectorized fast path ------------------------------------------------
    def _vec_link_codes(self, src: np.ndarray, dst: np.ndarray,
                        flow_id: int):
        """Encoded (uplink, downlink) codes of the non-local flows in
        ``(src, dst)``, as ``(keep_mask, upcodes, dncodes)`` — or ``None``
        when this routing must route flow-by-flow (stateful load tracking,
        job-specific source maps)."""
        return None

    def _vec_dense_ids(self, src: np.ndarray, dst: np.ndarray,
                       flow_id: int, ls: "LinkSpace"):
        """Dense :class:`LinkSpace` link ids of the non-local flows, as
        ``(keep_mask, up_ids, dn_ids)``.  Subclasses with a vectorized route
        override this to emit ids arithmetically; the base implementation
        decodes the 36-bit codes.  ``None`` when no vectorized path exists."""
        res = self._vec_link_codes(src, dst, flow_id)
        if res is None:
            return None
        m, upc, dnc = res
        return m, ls.ids_of_codes(upc), ls.ids_of_codes(dnc)

    def phase_link_counts(self, src: np.ndarray, dst: np.ndarray,
                          flow_id: int = 0) -> Optional[Counter]:
        """Per-link flow counts of one phase, vectorized. Semantically
        ``Counter(l for f in phase for l in route(f, flow_id))``; ``None``
        when no vectorized path exists."""
        res = self._vec_link_codes(src, dst, flow_id)
        if res is None:
            return None
        _, upc, dnc = res
        if not len(upc):
            return Counter()
        vals, cnts = np.unique(np.concatenate([upc, dnc]), return_counts=True)
        return _decode_link_counts(vals, cnts)

    # -- shared helpers -----------------------------------------------------
    def _is_local(self, flow: Flow) -> bool:
        s = self.spec
        return (s.server_of_gpu(flow.src) == s.server_of_gpu(flow.dst)
                or s.leaf_of_gpu(flow.src) == s.leaf_of_gpu(flow.dst))

    def _downlink(self, spine: int, leaf_dst: int, ch: int = 0) -> Link:
        return ("down", spine, leaf_dst, ch)

    def _uplink(self, leaf: int, spine: int, ch: int = 0) -> Link:
        return ("up", leaf, spine, ch)


class IdealRouting(Routing):
    """`Best` baseline: one giant non-blocking switch — nothing contends."""

    def route(self, flow: Flow, flow_id: int = 0) -> List[Link]:
        return []

    def _vec_link_codes(self, src: np.ndarray, dst: np.ndarray,
                        flow_id: int):
        empty = np.empty(0, dtype=np.int64)
        return np.zeros(len(src), dtype=bool), empty, empty

    def _vec_dense_ids(self, src: np.ndarray, dst: np.ndarray,
                       flow_id: int, ls: "LinkSpace"):
        empty = np.empty(0, dtype=np.int64)
        return np.zeros(len(src), dtype=bool), empty, empty


class SourceRouting(Routing):
    """Paper §5.2: per-leaf bijection from server-facing ports to uplinks.

    ``maps[n][i]`` gives the (spine, channel) uplink for server-port ``i`` of
    leaf ``n``.  The default map is the identity ``i -> spine i mod S`` which
    is the paper's canonical choice; vClos placements install job-specific
    maps over their reserved links (see placement.py).
    """

    def __init__(self, spec: ClusterSpec,
                 maps: Optional[Dict[int, Dict[int, Tuple[int, int]]]] = None):
        super().__init__(spec)
        self._default_maps = maps is None
        if maps is None:
            maps = {}
            for n in range(spec.num_leafs):
                maps[n] = {}
                for i in range(spec.gpus_per_leaf):
                    up = i * spec.channels  # first channel of port i's column
                    maps[n][i] = (up % spec.num_spines, up // spec.num_spines)
        self.maps = maps

    def route(self, flow: Flow, flow_id: int = 0) -> List[Link]:
        if self._is_local(flow):
            return []
        s = self.spec
        n = s.leaf_of_gpu(flow.src)
        k = s.leaf_of_gpu(flow.dst)
        port = s.port_of_gpu(flow.src)
        spine, ch = self.maps[n][port]
        return [self._uplink(n, spine, ch), self._downlink(spine, k, ch)]

    def _vec_link_codes(self, src: np.ndarray, dst: np.ndarray,
                        flow_id: int):
        if not self._default_maps:
            return None  # job-specific maps: route flow-by-flow
        s = self.spec
        leaf_s = src // s.gpus_per_leaf
        leaf_d = dst // s.gpus_per_leaf
        # same server ⇒ same leaf (servers are contiguous within a leaf), so
        # the leaf check alone reproduces _is_local
        m = leaf_s != leaf_d
        leaf_s, leaf_d = leaf_s[m], leaf_d[m]
        up = (src[m] % s.gpus_per_leaf) * s.channels
        spine = up % s.num_spines
        ch = up // s.num_spines
        return m, *np.split(_encode_links(leaf_s, spine, ch,
                                          spine, leaf_d, ch), 2)

    def _vec_dense_ids(self, src: np.ndarray, dst: np.ndarray,
                       flow_id: int, ls: "LinkSpace"):
        if not self._default_maps:
            return None  # job-specific maps: route flow-by-flow
        s = self.spec
        leaf_s = src // s.gpus_per_leaf
        leaf_d = dst // s.gpus_per_leaf
        m = leaf_s != leaf_d
        leaf_s, leaf_d = leaf_s[m], leaf_d[m]
        up = (src[m] % s.gpus_per_leaf) * s.channels
        spine = up % s.num_spines
        ch = up // s.num_spines
        up_ids = (leaf_s * s.num_spines + spine) * ls.channels + ch
        dn_ids = ls.half + (spine * s.num_leafs + leaf_d) * ls.channels + ch
        return m, up_ids, dn_ids


class ECMPRouting(Routing):
    """Hash-based uplink selection — the hash-collision baseline (§3.1)."""

    def __init__(self, spec: ClusterSpec, seed: int = 0):
        super().__init__(spec)
        self.seed = seed

    def route(self, flow: Flow, flow_id: int = 0) -> List[Link]:
        if self._is_local(flow):
            return []
        s = self.spec
        n = s.leaf_of_gpu(flow.src)
        k = s.leaf_of_gpu(flow.dst)
        nway = s.uplinks_per_leaf          # hash across every physical uplink
        up = ecmp_hash(flow.src, flow.dst, flow_id, self.seed, nway)
        spine, ch = up % s.num_spines, up // s.num_spines
        # downlink channel also hashed when redundant channels exist
        nch = s.base_channels
        dch = ecmp_hash(flow.dst, flow.src, flow_id, self.seed + 1,
                        nch) if nch > 1 else 0
        return [self._uplink(n, spine, ch), self._downlink(spine, k, dch)]

    def _vec_link_codes(self, src: np.ndarray, dst: np.ndarray,
                        flow_id: int):
        s = self.spec
        leaf_s = src // s.gpus_per_leaf
        leaf_d = dst // s.gpus_per_leaf
        m = leaf_s != leaf_d
        srcm, dstm = src[m], dst[m]
        up = ecmp_hash_vec(srcm, dstm, flow_id, self.seed, s.uplinks_per_leaf)
        spine = up % s.num_spines
        ch = up // s.num_spines
        nch = s.base_channels
        dch = (ecmp_hash_vec(dstm, srcm, flow_id, self.seed + 1, nch)
               if nch > 1 else np.zeros_like(spine))
        return m, *np.split(_encode_links(leaf_s[m], spine, ch,
                                          spine, leaf_d[m], dch), 2)

    def _vec_dense_ids(self, src: np.ndarray, dst: np.ndarray,
                       flow_id: int, ls: "LinkSpace"):
        s = self.spec
        leaf_s = src // s.gpus_per_leaf
        leaf_d = dst // s.gpus_per_leaf
        m = leaf_s != leaf_d
        srcm, dstm = src[m], dst[m]
        up = ecmp_hash_vec(srcm, dstm, flow_id, self.seed, s.uplinks_per_leaf)
        spine = up % s.num_spines
        ch = up // s.num_spines
        nch = s.base_channels
        dch = (ecmp_hash_vec(dstm, srcm, flow_id, self.seed + 1, nch)
               if nch > 1 else np.zeros_like(spine))
        up_ids = (leaf_s[m] * s.num_spines + spine) * ls.channels + ch
        dn_ids = ls.half + (spine * s.num_leafs + leaf_d[m]) * ls.channels + dch
        return m, up_ids, dn_ids


class BalancedECMPRouting(Routing):
    """Least-loaded uplink selection at flow start (§9.3 "Balanced").

    Stateful: tracks the load each routed flow leaves on links, so later
    flows avoid the loaded uplinks.  Downlink remains forced by destination.
    """

    def __init__(self, spec: ClusterSpec, seed: int = 0):
        super().__init__(spec)
        self.seed = seed
        self.load: Counter = Counter()

    def reset(self) -> None:
        self.load.clear()

    def route(self, flow: Flow, flow_id: int = 0) -> List[Link]:
        if self._is_local(flow):
            return []
        s = self.spec
        n = s.leaf_of_gpu(flow.src)
        k = s.leaf_of_gpu(flow.dst)
        best: Optional[Tuple[int, int, int]] = None  # (cost, spine, ch)
        start = ecmp_hash(flow.src, flow.dst, flow_id, self.seed,
                          s.uplinks_per_leaf)
        nway = s.uplinks_per_leaf
        for off in range(nway):
            up = (start + off) % nway
            spine, ch = up % s.num_spines, up // s.num_spines
            cost = (self.load[self._uplink(n, spine, ch)]
                    + self.load[self._downlink(spine, k, ch)])
            if best is None or cost < best[0]:
                best = (cost, spine, ch)
        _, spine, ch = best  # type: ignore[misc]
        links = [self._uplink(n, spine, ch), self._downlink(spine, k, ch)]
        for l in links:
            self.load[l] += 1
        return links


def multi_phase_link_counts(routing: Routing, src: np.ndarray,
                            dst: np.ndarray, phase_idx: np.ndarray,
                            num_phases: int,
                            flow_id: int = 0) -> Optional[List[Counter]]:
    """Per-link flow counts for several concurrent phases in one vectorized
    pass. ``phase_idx[i]`` assigns flow ``i`` to its phase; the result has
    one Counter per phase. ``None`` when ``routing`` has no vectorized path.
    """
    res = routing._vec_link_codes(src, dst, flow_id)
    if res is None:
        return None
    out: List[Counter] = [Counter() for _ in range(num_phases)]
    m, upc, dnc = res
    if not len(upc):
        return out
    ph = phase_idx[m]
    combo = np.concatenate([(ph << 36) | upc, (ph << 36) | dnc])
    u, c = np.unique(combo, return_counts=True)
    link_codes = (u & ((np.int64(1) << 36) - 1)).tolist()
    for p, v, cnt in zip((u >> 36).tolist(), link_codes, c.tolist()):
        out[p][_decode_link(v)] = int(cnt)
    return out


def alltoall_link_counts(routing: Routing, ranks: Sequence[int],
                         flow_id: int = 0) -> Optional[Counter]:
    """Worst-case per-link flow counts across the N-1 pairwise AlltoAll
    steps (step t: rank i → rank (i+t+1) mod N), fully vectorized.

    Equivalent to routing every step with :func:`pairwise_alltoall` flows,
    counting links per step, and taking the per-link max over steps — the
    simulator's aggregate-A2A collapse — without materialising ~N² Flow
    objects. Returns ``None`` when ``routing`` has no vectorized path.
    """
    n = len(ranks)
    if n < 2:
        return Counter()
    src, dst, all_steps = a2a_step_flows(ranks)
    res = routing._vec_link_codes(src, dst, flow_id)
    if res is None:
        return None
    m, upc, dnc = res
    if not len(upc):
        return Counter()
    # link codes occupy 36 bits; tag each with its step index, count per
    # (step, link), then take the max count per link across steps
    step = all_steps[m]
    combo = np.concatenate([(step << 36) | upc, (step << 36) | dnc])
    u, c = np.unique(combo, return_counts=True)
    link_codes = u & ((np.int64(1) << 36) - 1)
    uniq, inv = np.unique(link_codes, return_inverse=True)
    agg = np.zeros(len(uniq), dtype=np.int64)
    np.maximum.at(agg, inv, c)
    return _decode_link_counts(uniq, agg)


# ---------------------------------------------------------------------------
# Contention accounting
# ---------------------------------------------------------------------------

@dataclass
class ContentionReport:
    link_load: Dict[Link, int] = field(default_factory=dict)
    per_flow_max: List[int] = field(default_factory=list)

    @property
    def max_load(self) -> int:
        return max(self.link_load.values(), default=0)

    @property
    def contended_flows(self) -> int:
        return sum(1 for m in self.per_flow_max if m > 1)

    @property
    def is_contention_free(self) -> bool:
        return self.max_load <= 1


def contention(phase: Phase, routing: Routing) -> ContentionReport:
    """Per-link flow counts for one concurrent phase under ``routing``."""
    routes = routing.route_phase(phase)
    load: Counter = Counter()
    for links in routes:
        for l in links:
            load[l] += 1
    per_flow = [max((load[l] for l in links), default=0) for links in routes]
    return ContentionReport(link_load=dict(load), per_flow_max=per_flow)


def phase_contention_profile(phases: Sequence[Phase],
                             routing: Routing) -> List[ContentionReport]:
    reports = []
    for p in phases:
        if isinstance(routing, BalancedECMPRouting):
            routing.reset()
        reports.append(contention(p, routing))
    return reports


def contention_histogram(phase: Phase, routing: Routing) -> Dict[int, int]:
    """#flows experiencing a given max link load (paper Fig. 2 statistic)."""
    rep = contention(phase, routing)
    hist: Counter = Counter()
    for m in rep.per_flow_max:
        if m >= 1:
            hist[m] += 1
    return dict(hist)
