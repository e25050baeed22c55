"""Lane-batched flat-array simulation engine (``engine="batched"``).

Campaign sweeps run the same event-driven simulation over many independent
cells (strategy × load × seed).  The v2 engine advances one cell at a time
through Python-object state (heap entries, per-job ``_RunJobV2`` attribute
reads); this engine advances many cells — *lanes* — in lockstep rounds over
flat, fixed-shape numpy arrays:

  * per-lane fabric state: ``server_free`` / ``gpu_free`` occupancy vectors,
    a dense :class:`~repro_torch.core.routing.LinkSpace` link-load row, and the v2
    link→job bitset for O(dirty) affected-set lookups;
  * per-(lane, slot) dynamic state: ``t_fin`` / ``order`` / ``rate`` /
    ``iters_left`` / ``last_update`` live in ``(L, S)`` arrays, so the next
    event of *every* lane is one masked ``argmin`` sweep instead of L heap
    pops;
  * rate resolution batches **across lanes**: every affected job of every
    lane concatenates into one CSR call to
    :func:`repro_torch.core.fairshare.phase_worst_loads` (the Hopper
    segment-max kernel of ``repro_torch.kernels.phase_max`` on ``cuda``, its
    plain version on ``cpu``), and the share →
    effective-iteration → rate → completion-time math runs vectorized over
    the whole affected set via masked cumulative sums.

Per-trace **precompute** makes placements cheap: collective flow patterns
are positionally equivariant (``flows(gpus) == gpus[flows(arange(n))]``),
so the rank-level (src, dst, phase) arrays, phase byte counts and both
contention-free iteration times are computed once per (model, batch, size,
algo) and shared by every lane of the trace.

**Oracle contract** (docs/batched.md): the sequential v1/v2 engines remain
the ground truth.  This engine replicates their arithmetic operation-for
-operation (same left-to-right accumulations, same guards), so qualifying
runs are *bit-exact* — asserted per strategy by ``tests/test_batched.py``
and as a hypothesis property in ``tests/test_properties.py``.  A cell
qualifies when its behaviour is structurally lane-batchable: builtin
``best`` / ``sr`` / ``ecmp`` strategy (stateless vectorized routing +
locality-packed placement), ``fifo`` queueing, no dynamic events, no
defrag, no time limit.  Everything else transparently delegates to v2 —
``engine="batched"`` never changes a schedule, only how fast it is
computed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from .fairshare import phase_worst_loads
from .jobs import GBPS, Job
from .metrics import MetricsReport, job_metrics
from .routing import (ECMPRouting, IdealRouting, LinkSpace, SourceRouting,
                      a2a_step_flows, multi_phase_dense_counts)
from .strategies import strategy_names
from .strategies.builtin import (BestStrategy, ECMPStrategy,
                                 SourceRoutingStrategy)

NVLINK_SPEEDUP = 12.0   # keep in sync with simulator.NVLINK_SPEEDUP
                        # (asserted by tests/test_batched.py)

_FAST_STRATEGY_TYPES = (BestStrategy, SourceRoutingStrategy, ECMPStrategy)
_ORDER_MAX = np.iinfo(np.int64).max
_INIT_SLOTS = 64        # (L, S) column count; doubles on demand like v2

solves = 0   # lane-engine rate-resolution solves (phase_worst_loads calls)


def config_qualifies(config) -> bool:
    """Can a cell with this :class:`~repro_torch.core.config.SimConfig` run on the
    lane-batched fast path?  Structural test — the exact strategy *types*
    whose placement + routing this engine replicates (a re-registered
    plugin under the same name disqualifies), plus fifo queueing, no
    events, no defrag, no time limit."""
    if (isinstance(config.strategy, str)
            and config.strategy not in strategy_names()):
        return False           # unregistered since the config was built
    strat = config.resolve_strategy()
    return (type(strat) in _FAST_STRATEGY_TYPES
            and config.scheduler == "fifo"
            and not config.events
            and config.defrag_interval == 0.0
            and math.isinf(config.max_time))


def _routing_qualifies(routing) -> bool:
    return (type(routing) is IdealRouting
            or type(routing) is ECMPRouting
            or (type(routing) is SourceRouting and routing._default_maps))


# ---------------------------------------------------------------------------
# Per-trace precompute: rank-level flow patterns + sealed phase bytes
# ---------------------------------------------------------------------------

class _JobPre:
    """Placement-independent per-job constants, shared across lanes via a
    (model, batch, size, algo) cache.  ``src_r``/``dst_r`` index into the
    job's placed-GPU array (positional equivariance of the collective
    generators); ``nb_arr``/``nar``/``collapse`` mirror the v2 builder's
    sealed phase bytes including the left-to-right a2a byte sum."""

    __slots__ = ("n", "nar", "nph", "n_a2a_steps", "nb_arr", "c", "beta",
                 "ii_intra", "ii_fabric", "collapse", "src_r", "dst_r",
                 "pidx_r", "has_flows")


def _iter_ideal(nb_arr: Optional[np.ndarray], nar: int, c: float,
                beta: float, link_gbps: float, intra: bool) -> float:
    # contention-free twin of _RunJobV2.iter_effective(ones, gbps): same
    # expression, same cumsum accumulation order
    bw = link_gbps * GBPS * (NVLINK_SPEEDUP if intra else 1.0)
    if nb_arr is None:
        return c + max(0.0, -beta * c)
    shares = np.ones(len(nb_arr))
    t = nb_arr / (bw * np.maximum(shares, 1e-9))
    t_ar = float(t[:nar].cumsum()[-1]) if nar else 0.0
    t_a2a = float(t[nar:].cumsum()[-1]) if len(t) > nar else 0.0
    return c + max(0.0, t_ar - beta * c) + t_a2a


def _build_pre(job: Job, link_gbps: float) -> _JobPre:
    pre = _JobPre()
    n = job.num_gpus
    pre.n = n
    metas, asrc, adst, aidx = job.ar_phase_arrays(np.arange(n))
    nar = len(metas)
    nb: List[float] = [b for _k, b in metas]
    has_a2a = job.profile.alltoall_bytes > 0 and n >= 2
    pre.collapse = False
    if has_a2a:
        # byte accounting must stay ULP-identical to the engines'
        # _append_a2a_meta: share = bytes/n, left-to-right python sum
        share = job.profile.alltoall_bytes / n
        if n - 1 > 8:
            nb.append(sum([share] * (n - 1)))
            pre.collapse = True
        else:
            nb.extend([share] * (n - 1))
    pre.nar = nar
    pre.nph = len(nb)
    pre.n_a2a_steps = (n - 1) if has_a2a else 0
    pre.nb_arr = np.asarray(nb, dtype=np.float64) if nb else None
    pre.c = job.compute_time()
    pre.beta = job.profile.overlap_beta
    pre.ii_intra = _iter_ideal(pre.nb_arr, nar, pre.c, pre.beta,
                               link_gbps, True)
    pre.ii_fabric = _iter_ideal(pre.nb_arr, nar, pre.c, pre.beta,
                                link_gbps, False)
    if has_a2a:
        a2s, a2d, a2step = a2a_step_flows(np.arange(n))
        pre.src_r = np.concatenate([asrc, a2s])
        pre.dst_r = np.concatenate([adst, a2d])
        pre.pidx_r = np.concatenate([aidx, nar + a2step])
    else:
        pre.src_r, pre.dst_r, pre.pidx_r = asrc, adst, aidx
    pre.has_flows = len(pre.src_r) > 0
    return pre


# (model, batch, size, algo, link_gbps) -> _JobPre.  Module-level and
# immutable once built: the inputs are pure functions of the builtin
# ModelProfile table, so entries are valid across traces and sessions.
_PRE_CACHE: Dict[tuple, _JobPre] = {}


def _pres_for(jobs: Sequence[Job], link_gbps: float) -> List[_JobPre]:
    cache = _PRE_CACHE
    out = []
    for job in jobs:
        key = (job.model, job.batch_size, job.num_gpus, job.allreduce_algo,
               link_gbps)
        pre = cache.get(key)
        if pre is None:
            pre = cache[key] = _build_pre(job, link_gbps)
        out.append(pre)
    return out


# ---------------------------------------------------------------------------
# Lane state
# ---------------------------------------------------------------------------

class _Run:
    """Static per-running-job data; the dynamic scalars (rate, iters_left,
    last_update, t_fin, order) live in the engine's (L, S) arrays."""

    __slots__ = ("job", "jidx", "pre", "gpus", "srv_u", "cnt_u",
                 "iter_ideal", "uidx", "uval",
                 "cat_idx", "cat_cnt", "cat_ucnt", "pptr")

    def __init__(self, job, jidx, pre, gpus, srv_u, cnt_u, iter_ideal):
        self.job = job
        self.jidx = jidx
        self.pre = pre
        self.gpus = gpus
        self.srv_u = srv_u            # unique servers + their GPU counts:
        self.cnt_u = cnt_u            # one fancy += replaces np.add.at
        self.iter_ideal = iter_ideal
        self.uidx = None
        self.uval = None
        self.cat_idx = None
        self.cat_cnt = None
        self.cat_ucnt = None
        self.pptr = None


class _Lane:
    """One simulation cell: its jobs (arrival-sorted copies), precompute,
    routing instance, and flat fabric/queue state.  The FIFO queue is a
    contiguous arrival-order window ``[qh, qt)`` — under strict head-of
    -line blocking, placed jobs are always a queue prefix."""

    def __init__(self, idx: int, spec, ls: LinkSpace, jobs: List[Job],
                 pres: List[_JobPre], routing, isolated: bool):
        self.idx = idx
        self.jobs = jobs
        self.pres = pres
        self.routing = routing
        self.isolated = isolated
        if type(routing) is IdealRouting:
            self.route_key = None
        elif type(routing) is ECMPRouting:
            self.route_key = ("ecmp", routing.seed)
        else:
            self.route_key = ("sr",)
        # dynamic scalars (clock, queue window [qh, qt), blocked memo,
        # state version, order counter, free-GPU total) live in engine
        # -level (L,) arrays so the round loop reads/updates them with
        # vector ops; row views into the engine's (L, num_servers) /
        # (L, num_gpus) planes are set by the engine: per-lane code
        # mutates them in place, round-batched passes scatter directly
        self.server_free: Optional[np.ndarray] = None
        self.gpu_free: Optional[np.ndarray] = None
        self.load = np.zeros(ls.nlinks, dtype=np.int64)
        self.users = np.zeros((ls.nlinks, _INIT_SLOTS // 64), dtype=np.uint64)
        self.slot_map: List[Optional[_Run]] = [None] * _INIT_SLOTS
        self.dirty: List[np.ndarray] = []
        self.frag_reason: Dict[int, str] = {}
        self.slowdowns: Dict[int, float] = {}
        self.done = False
        # trace columns + deferred job accounting (Job objects are only
        # touched once, in _finalize, so event handlers stay array-only)
        nj = len(jobs)
        self.nj = nj
        self.arrivals = np.asarray([j.arrival for j in jobs])
        self.n_gpus = np.asarray([j.num_gpus for j in jobs], dtype=np.int64)
        self.n_iters = np.asarray([float(j.num_iters) for j in jobs])
        self.iters0 = np.asarray(
            [float(j.num_iters) if j.remaining_iters is None
             else float(j.remaining_iters) for j in jobs])
        self.start_t = np.asarray(
            [math.nan if j.start_time is None else float(j.start_time)
             for j in jobs])
        self.had_start = ~np.isnan(self.start_t)
        self.finish_t = np.full(nj, math.nan)
        self.ii_used = np.zeros(nj)
        self.finalized = False

    def _finalize(self) -> None:
        """Apply the deferred accounting to the Job objects and build the
        slowdown map — one pass per lane, exactly v2's `_finish_job` math
        ((now - start) / (num_iters * iter_ideal), same IEEE ops)."""
        if self.finalized:
            return
        self.finalized = True
        jobs = self.jobs
        fin = ~np.isnan(self.finish_t)
        for i in np.flatnonzero(fin):
            jobs[i].finish_time = float(self.finish_t[i])
        for i in np.flatnonzero(~self.had_start & ~np.isnan(self.start_t)):
            jobs[i].start_time = float(self.start_t[i])
        ideal = self.n_iters * self.ii_used
        ok = fin & ~np.isnan(self.start_t) & (ideal > 0)
        sd = np.where(ok, (self.finish_t - self.start_t)
                      / np.where(ok, ideal, 1.0), 0.0)
        for i in np.flatnonzero(ok):
            self.slowdowns[jobs[i].job_id] = float(sd[i])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class _BatchedEngine:
    def __init__(self, spec, lanes: List[_Lane], device):
        self.spec = spec
        self.ls = LinkSpace(spec)
        self.lanes = lanes
        self.device = device
        self._entry_cache: Dict[tuple, tuple] = {}
        L = len(lanes)
        S = _INIT_SLOTS
        self.S = S
        inf = math.inf
        self.t_fin = np.full((L, S), inf)
        self.order = np.full((L, S), _ORDER_MAX, dtype=np.int64)
        self.rate = np.ones((L, S))
        self.iters_left = np.zeros((L, S))
        self.last_update = np.zeros((L, S))
        # static per-job scalars, slot-resident so _recompute gathers them
        # with fancy indexing instead of per-object attribute walks
        self.meta_nph = np.zeros((L, S), dtype=np.int64)
        self.meta_nar = np.zeros((L, S), dtype=np.int64)
        self.meta_c = np.zeros((L, S))
        self.meta_beta = np.zeros((L, S))
        self.meta_ii = np.zeros((L, S))
        self.arr_next = np.asarray(
            [ln.jobs[0].arrival if ln.jobs else inf for ln in lanes])
        # one (L, num_servers) plane; each lane holds its row as a view so
        # per-lane code mutates it in place while the scheduling pass can
        # gather all rows with one fancy index
        self.server_free = np.full((L, spec.num_servers),
                                   spec.gpus_per_server, dtype=np.int64)
        self.gpu_free = np.ones((L, spec.num_gpus), dtype=bool)
        # plane-resident stage0 (intra) runs: single-server placements never
        # touch the fabric, so their whole lifecycle lives in flat arrays —
        # jidx (-1 = empty or fabric run), server, GPU count, and the
        # within-server GPU bitmask driving the release scatter
        self.slot_jidx = np.full((L, S), -1, dtype=np.int64)
        self.slot_srv = np.zeros((L, S), dtype=np.int64)
        self.slot_cnt = np.zeros((L, S), dtype=np.int64)
        self.slot_mask = np.zeros((L, S), dtype=np.int64)
        # slot free list as linked planes (free_head[l] heads the chain in
        # next_free[l]): groups of lanes pop/push one slot each with two
        # gathers/scatters instead of per-lane list ops
        self.next_free = np.tile(np.r_[np.arange(1, S), -1], (L, 1))
        self.free_head = np.zeros(L, dtype=np.int64)
        # per-lane dynamic scalars as (L,) arrays: the round loop updates
        # whole groups of lanes with one gather/scatter each
        self.now_a = np.zeros(L)
        self.qh_a = np.zeros(L, dtype=np.int64)   # queue window [qh, qt)
        self.qt_a = np.zeros(L, dtype=np.int64)
        self.ai_a = np.zeros(L, dtype=np.int64)   # next arrival index
        self.sv_a = np.zeros(L, dtype=np.int64)   # fabric state version
        self.blkq_a = np.full(L, -1, dtype=np.int64)  # blocked memo:
        self.blkv_a = np.full(L, -1, dtype=np.int64)  # (qh, state version)
        self.ft_a = np.full(L, spec.num_gpus, dtype=np.int64)  # free GPUs
        self.oc_a = np.zeros(L, dtype=np.int64)   # v2 heap-order counters
        # per-job trace/accounting planes (padded to the longest lane; the
        # extra inf column lets the arrival gather run off the trace end);
        # each lane's own arrays are replaced by row-prefix views so the
        # per-lane fallback paths and _finalize read the same storage
        NJ = max((ln.nj for ln in lanes), default=0)
        self.j_n = np.zeros((L, NJ + 1), dtype=np.int64)
        self.j_arr = np.full((L, NJ + 1), inf)
        self.j_it0 = np.zeros((L, NJ + 1))
        self.j_ii_intra = np.zeros((L, NJ + 1))
        self.j_start = np.full((L, NJ + 1), math.nan)
        self.j_hadst = np.zeros((L, NJ + 1), dtype=bool)
        self.j_fin = np.full((L, NJ + 1), math.nan)
        self.j_iiu = np.zeros((L, NJ + 1))
        for l, ln in enumerate(lanes):
            ln.server_free = self.server_free[l]
            ln.gpu_free = self.gpu_free[l]
            nj = ln.nj
            self.j_n[l, :nj] = ln.n_gpus
            self.j_arr[l, :nj] = ln.arrivals
            self.j_it0[l, :nj] = ln.iters0
            self.j_ii_intra[l, :nj] = [p.ii_intra for p in ln.pres]
            self.j_start[l, :nj] = ln.start_t
            self.j_hadst[l, :nj] = ln.had_start
            ln.n_gpus = self.j_n[l, :nj]
            ln.arrivals = self.j_arr[l, :nj]
            ln.iters0 = self.j_it0[l, :nj]
            ln.start_t = self.j_start[l, :nj]
            ln.had_start = self.j_hadst[l, :nj]
            ln.finish_t = self.j_fin[l, :nj]
            ln.ii_used = self.j_iiu[l, :nj]

    # -- slots ---------------------------------------------------------------
    def _grow_slots(self) -> None:
        S = self.S
        L = len(self.lanes)
        self.t_fin = np.hstack([self.t_fin, np.full((L, S), math.inf)])
        self.order = np.hstack(
            [self.order, np.full((L, S), _ORDER_MAX, dtype=np.int64)])
        self.rate = np.hstack([self.rate, np.ones((L, S))])
        self.iters_left = np.hstack([self.iters_left, np.zeros((L, S))])
        self.last_update = np.hstack([self.last_update, np.zeros((L, S))])
        for name in ("meta_nph", "meta_nar", "meta_c", "meta_beta",
                     "meta_ii"):
            arr = getattr(self, name)
            setattr(self, name,
                    np.hstack([arr, np.zeros((L, S), dtype=arr.dtype)]))
        for name in ("slot_srv", "slot_cnt", "slot_mask"):
            arr = getattr(self, name)
            setattr(self, name,
                    np.hstack([arr, np.zeros((L, S), dtype=np.int64)]))
        self.slot_jidx = np.hstack(
            [self.slot_jidx, np.full((L, S), -1, dtype=np.int64)])
        # chain the new slots S..2S-1 in front of each lane's current list
        ext = np.tile(np.r_[np.arange(S + 1, 2 * S), -1], (L, 1))
        ext[:, -1] = self.free_head
        self.next_free = np.hstack([self.next_free, ext])
        self.free_head[:] = S
        for ln in self.lanes:
            ln.users = np.hstack([ln.users, np.zeros_like(ln.users)])
            ln.slot_map.extend([None] * S)
        self.S = 2 * S

    # -- placement (exact locality_packed_place twin over flat state) --------
    def _place(self, l: int, lane: _Lane, n: int):
        """Choose GPUs for an ``n``-GPU job, or None.  Returns
        ``(gpus, srv_u, cnt_u)`` — the placement always consists of whole
        -server blocks plus one partial tail, so the unique per-server GPU
        counts come for free (one fancy ``-=``/``+=`` then replaces
        ``np.add.at`` on both commit and release)."""
        spec = self.spec
        if self.ft_a[l] < n:
            return None
        gps = spec.gpus_per_server
        if n <= gps:
            # stage0 best fit as one masked argmin: first-occurrence argmin
            # keeps stage0_server's lowest-id tie-break among best fits
            free = lane.server_free
            big = gps + 1
            masked = np.where(free >= n, free, big)
            best = int(np.argmin(masked))
            if masked[best] == big:
                return None
            base = best * gps
            idle = np.flatnonzero(lane.gpu_free[base:base + gps])
            return (idle[:n] + base, np.asarray([best], dtype=np.int64),
                    np.asarray([n], dtype=np.int64))
        spl = spec.servers_per_leaf
        req = -(-n // gps)   # ceil
        idle_mask = lane.server_free == gps
        counts = idle_mask.reshape(spec.num_leafs, spl).sum(axis=1)
        big = spl + 1
        masked = np.where(counts >= req, counts, big)
        best = int(np.argmin(masked))
        if masked[best] != big:
            servers = (np.flatnonzero(idle_mask[best * spl:(best + 1) * spl])
                       [:req] + best * spl)
        else:
            # collect_idle_servers: whole idle servers, fewest-idle leafs
            # first, leaf id breaking count ties — vectorized as a stable
            # argsort of each idle server's leaf-walk rank (within a leaf,
            # flatnonzero order = ascending server id, exactly the v2 walk)
            nzl = np.flatnonzero(counts)
            if int(counts[nzl].sum()) < req:
                return None
            order = nzl[np.argsort(counts[nzl], kind="stable")]
            rank = np.full(spec.num_leafs, spec.num_leafs, dtype=np.int64)
            rank[order] = np.arange(len(order))
            idle_srv = np.flatnonzero(idle_mask)
            keys = rank[idle_srv // spl]
            servers = idle_srv[np.argsort(keys, kind="stable")][:req]
        gpus = (servers[:, None] * gps + np.arange(gps)[None, :]).ravel()[:n]
        cnt_u = np.full(req, gps, dtype=np.int64)
        cnt_u[-1] = n - (req - 1) * gps
        return gpus, servers, cnt_u

    # -- per-job link entries (same dense build as the v2 engine) ------------
    def _build_entries(self, lane: _Lane, pre: _JobPre, gpus: np.ndarray,
                       job_id: int):
        # Builds are a pure function of (flow pattern, placed GPUs, routing)
        # — for ECMP also the job id hashed into the 5-tuple — and packed
        # placements recur heavily across lanes, so cache the CSR entries.
        # Cached arrays are shared read-only between running jobs/lanes.
        rk = lane.route_key
        if rk is None:              # IdealRouting: never touches the fabric
            return None
        if rk[0] == "ecmp":
            key = (id(pre), gpus.tobytes(), rk[1], job_id)
        else:                       # sr default maps ignore the flow id
            key = (id(pre), gpus.tobytes())
        ent = self._entry_cache.get(key)
        if ent is None:
            src = gpus[pre.src_r]
            dst = gpus[pre.dst_r]
            nphases = pre.nar + pre.n_a2a_steps
            # two builds, same CSR (both row-major (phase, link), counts
            # identical): the dense bincount wins when the (nphases, nlinks)
            # matrix is small relative to the flow batch, the sort-based
            # sparse build wins on big fabrics where the matrix is mostly
            # zeros-allocation
            if nphases * self.ls.nlinks > 64 * (len(src) + 64):
                ent = self._sparse_entries(lane, pre, src, dst, job_id)
            else:
                ent = self._dense_entries(lane, pre, src, dst, job_id,
                                          nphases)
            self._entry_cache[key] = ent
        return ent if ent else None

    def _dense_entries(self, lane: _Lane, pre: _JobPre, src, dst,
                       job_id: int, nphases: int):
        # _build_running_v2's fabric branch on the precomputed rank
        # patterns: one bincount sweep over the whole (AR + a2a) flow
        # batch, then the a2a collapse and _attach_dense_phases in CSR
        mat = multi_phase_dense_counts(lane.routing, self.ls, src, dst,
                                       pre.pidx_r, nphases, job_id)
        if pre.collapse:
            mat = np.vstack([mat[:pre.nar],
                             mat[pre.nar:].max(axis=0, keepdims=True)])
        union = mat.max(axis=0)
        uidx = np.nonzero(union)[0]
        if not len(uidx):
            return ()
        nz_ph, nz_l = np.nonzero(mat)
        pptr = np.searchsorted(nz_ph, np.arange(pre.nph + 1))
        return (uidx, union[uidx], nz_l, mat[nz_ph, nz_l], union[nz_l],
                pptr)

    def _sparse_entries(self, lane: _Lane, pre: _JobPre, src, dst,
                        job_id: int):
        # sort/unique over (phase, link) keys — counts and row-major order
        # identical to the dense matrix's np.nonzero walk
        res = lane.routing._vec_dense_ids(src, dst, job_id, self.ls)
        _m, up, dn = res
        if not len(up):
            return ()
        nlinks = self.ls.nlinks
        pidx = pre.pidx_r[_m]
        keys = np.concatenate([pidx * nlinks + up, pidx * nlinks + dn])
        uniq, cnt = np.unique(keys, return_counts=True)
        ph = uniq // nlinks
        li = uniq - ph * nlinks
        # per-link union = column max of the dense matrix; computing it on
        # the pre-collapse entries is identical (max is associative)
        o = np.argsort(li, kind="stable")
        li_s, cnt_s = li[o], cnt[o]
        starts = np.flatnonzero(np.r_[True, li_s[1:] != li_s[:-1]])
        uidx = li_s[starts]
        uval = np.maximum.reduceat(cnt_s, starts)
        if pre.collapse:
            # fold the n-1 AlltoAll step rows into one aggregate phase of
            # per-link maxima (v2: mat[nar:].max(axis=0))
            arm = ph < pre.nar
            al, ac = li[~arm], cnt[~arm]
            if len(al):
                o2 = np.argsort(al, kind="stable")
                al_s, ac_s = al[o2], ac[o2]
                st2 = np.flatnonzero(np.r_[True, al_s[1:] != al_s[:-1]])
                cl, cc = al_s[st2], np.maximum.reduceat(ac_s, st2)
            else:
                cl, cc = al, ac
            ph = np.concatenate([ph[arm],
                                 np.full(len(cl), pre.nar, dtype=np.int64)])
            li = np.concatenate([li[arm], cl])
            cnt = np.concatenate([cnt[arm], cc])
        pptr = np.searchsorted(ph, np.arange(pre.nph + 1))
        return (uidx, uval, li, cnt, uval[np.searchsorted(uidx, li)], pptr)

    # -- running-set mutation ------------------------------------------------
    def _add_running(self, l: int, lane: _Lane, jidx: int, job: Job,
                     gpus: np.ndarray, srv_u: np.ndarray,
                     cnt_u: np.ndarray) -> None:
        pre = lane.pres[jidx]
        intra = len(srv_u) == 1
        iter_ideal = pre.ii_intra if intra else pre.ii_fabric
        if self.free_head[l] < 0:
            self._grow_slots()
        slot = int(self.free_head[l])
        self.free_head[l] = self.next_free[l, slot]
        run = _Run(job, jidx, pre, gpus, srv_u, cnt_u, iter_ideal)
        lane.slot_map[slot] = run
        iters_left = lane.iters0[jidx]
        lane.ii_used[jidx] = iter_ideal
        now = float(self.now_a[l])
        self.rate[l, slot] = 1.0
        self.iters_left[l, slot] = iters_left
        self.last_update[l, slot] = now
        # _finish_time at rate 1.0 (max(1.0, 1e-12) == 1.0)
        self.t_fin[l, slot] = now + iters_left * iter_ideal / 1.0
        self.order[l, slot] = self.oc_a[l]
        self.oc_a[l] += 1
        if not lane.isolated and not intra and pre.has_flows:
            entries = self._build_entries(lane, pre, gpus, job.job_id)
            if entries is not None:
                (run.uidx, run.uval, run.cat_idx, run.cat_cnt,
                 run.cat_ucnt, run.pptr) = entries
                self.meta_nph[l, slot] = pre.nph
                self.meta_nar[l, slot] = pre.nar
                self.meta_c[l, slot] = pre.c
                self.meta_beta[l, slot] = pre.beta
                self.meta_ii[l, slot] = iter_ideal
                lane.load[run.uidx] += run.uval
                lane.dirty.append(run.uidx)
                lane.users[run.uidx, slot >> 6] |= np.uint64(
                    1 << (slot & 63))

    def _commit(self, l: int, lane: _Lane, gpus: np.ndarray,
                srv_u: np.ndarray, cnt_u: np.ndarray) -> None:
        """Place the head-of-line job on ``gpus`` (already chosen);
        ``srv_u``/``cnt_u`` are its unique servers and per-server GPU
        counts (known to the placer for free — whole blocks + one tail)."""
        jidx = int(self.qh_a[l])
        job = lane.jobs[jidx]
        lane.gpu_free[gpus] = False
        lane.server_free[srv_u] -= cnt_u
        self.ft_a[l] -= len(gpus)
        self.sv_a[l] += 1
        if not lane.had_start[jidx]:   # v2: set start_time only when unset
            lane.start_t[jidx] = self.now_a[l]
        self._add_running(l, lane, jidx, job, gpus, srv_u, cnt_u)
        self.qh_a[l] += 1

    def _try_schedule(self, l: int, lane: _Lane) -> None:
        qh = int(self.qh_a[l])
        if self.blkq_a[l] == qh and self.blkv_a[l] == self.sv_a[l]:
            return   # memoised head-of-line block (pure function of state)
        qt = int(self.qt_a[l])
        while qh < qt:
            placed = self._place(l, lane, int(lane.n_gpus[qh]))
            if placed is None:
                # locality-packed placement only ever fails on GPUs
                lane.frag_reason.setdefault(lane.jobs[qh].job_id, "gpu")
                self.blkq_a[l] = qh
                self.blkv_a[l] = self.sv_a[l]
                return
            self._commit(l, lane, *placed)
            qh += 1

    def _schedule_lanes(self, act: np.ndarray) -> None:
        """End-of-round scheduling pass over the lanes in ``act``.  Each
        lane saw exactly one event this round, so scheduling after all of
        them is identical to v2's schedule-after-each-event.  Head-of-line
        placement is vectorized across lanes — stage0 (small job: best-fit
        server) as one masked argmin over ``server_free`` rows followed by
        a grouped commit (single-server placements are intra -> isolated
        from the fabric: no entries, no meta planes, so the whole group
        commits with a handful of scatters), stage1 (big job: fewest-whole
        -idle-servers leaf) as one masked argmin over per-leaf idle counts
        — and repeated while lanes keep placing, so queues drain together.
        Stage1 misses (the rare cross-leaf collect) and singleton groups
        fall back to the per-lane loop."""
        lanes = self.lanes
        spec = self.spec
        gps = spec.gpus_per_server
        spl = spec.servers_per_leaf
        bigc = gps + 1
        bigl = spl + 1
        qh_a = self.qh_a
        qt_a = self.qt_a
        sel = ((qh_a[act] < qt_a[act])
               & ~((self.blkq_a[act] == qh_a[act])
                   & (self.blkv_a[act] == self.sv_a[act])))
        cand = act[sel]
        while len(cand) > 1:
            heads = qh_a[cand]
            nh = self.j_n[cand, heads]
            sm = nh <= gps
            srows = cand[sm]
            brows = cand[~sm]
            parts: List[np.ndarray] = []
            if len(srows) > 1:
                n = nh[sm]
                sf = self.server_free[srows]
                masked = np.where(sf >= n[:, None], sf, bigc)
                best = np.argmin(masked, axis=1)
                ok = masked[np.arange(len(srows)), best] < bigc
                bad = srows[~ok]
                if len(bad):
                    # stage0 is terminal for n <= gps: mark blocked
                    self.blkq_a[bad] = qh_a[bad]
                    self.blkv_a[bad] = self.sv_a[bad]
                    for l in bad:
                        lane = lanes[l]
                        lane.frag_reason.setdefault(
                            lane.jobs[int(qh_a[l])].job_id, "gpu")
                crows = srows[ok]
                if len(crows):
                    srvs = best[ok].astype(np.int64)
                    ns = n[ok]
                    jidxs = heads[sm][ok]
                    blk = self.gpu_free[crows[:, None],
                                        srvs[:, None] * gps
                                        + np.arange(gps)[None, :]]
                    # first ns idle GPUs per server, ascending — np.nonzero
                    # row-major order matches the per-lane idle[:n]
                    pick = blk & (np.cumsum(blk, axis=1) <= ns[:, None])
                    rr, cc = np.nonzero(pick)
                    gpu_ids = srvs[rr] * gps + cc
                    self.gpu_free[crows[rr], gpu_ids] = False
                    self.server_free[crows, srvs] -= ns
                    now_g = self.now_a[crows]
                    it0_g = self.j_it0[crows, jidxs]
                    ii_g = self.j_ii_intra[crows, jidxs]
                    upd = ~self.j_hadst[crows, jidxs]
                    # v2: set start_time only when unset
                    self.j_start[crows[upd], jidxs[upd]] = now_g[upd]
                    self.j_iiu[crows, jidxs] = ii_g
                    self.ft_a[crows] -= ns
                    self.sv_a[crows] += 1
                    ord_g = self.oc_a[crows]
                    self.oc_a[crows] += 1
                    qh_a[crows] += 1
                    # plane-resident runs: one grouped slot pop off the
                    # linked free lists, then scatter the run record
                    if (self.free_head[crows] < 0).any():
                        self._grow_slots()
                    slots_g = self.free_head[crows]
                    self.free_head[crows] = self.next_free[crows, slots_g]
                    self.slot_jidx[crows, slots_g] = jidxs
                    self.slot_srv[crows, slots_g] = srvs
                    self.slot_cnt[crows, slots_g] = ns
                    self.slot_mask[crows, slots_g] = (
                        pick * (np.int64(1) << np.arange(gps))).sum(axis=1)
                    self.rate[crows, slots_g] = 1.0
                    self.iters_left[crows, slots_g] = it0_g
                    self.last_update[crows, slots_g] = now_g
                    # _finish_time at rate 1.0 (max(1.0, 1e-12) == 1.0)
                    self.t_fin[crows, slots_g] = now_g + it0_g * ii_g
                    self.order[crows, slots_g] = ord_g
                    parts.append(crows[qh_a[crows] < qt_a[crows]])
            elif len(srows):
                l = int(srows[0])
                self._try_schedule(l, lanes[l])
            if len(brows) > 1:
                n = nh[~sm]
                req = -(-n // gps)
                idle = self.server_free[brows] == gps
                counts = idle.reshape(len(brows), spec.num_leafs,
                                      spl).sum(axis=2)
                masked = np.where(counts >= req[:, None], counts, bigl)
                best = np.argmin(masked, axis=1)
                ok = masked[np.arange(len(brows)), best] < bigl
                surv: List[int] = []
                for k, l in enumerate(brows):
                    l = int(l)
                    lane = lanes[l]
                    if not ok[k]:
                        # no single leaf fits: per-lane collect fallback
                        self._try_schedule(l, lane)
                        continue
                    leaf = int(best[k])
                    r = int(req[k])
                    nn = int(n[k])
                    servers = (np.flatnonzero(
                        idle[k, leaf * spl:(leaf + 1) * spl])[:r]
                        + leaf * spl)
                    gpus = (servers[:, None] * gps
                            + np.arange(gps)[None, :]).ravel()[:nn]
                    cnt_u = np.full(r, gps, dtype=np.int64)
                    cnt_u[-1] = nn - (r - 1) * gps
                    self._commit(l, lane, gpus, servers, cnt_u)
                    if qh_a[l] < qt_a[l]:
                        surv.append(l)
                if surv:
                    parts.append(np.asarray(surv, dtype=np.int64))
            elif len(brows):
                l = int(brows[0])
                self._try_schedule(l, lanes[l])
            cand = (parts[0] if len(parts) == 1
                    else np.concatenate(parts) if parts
                    else np.empty(0, dtype=np.int64))
        for l in cand:
            l = int(l)
            self._try_schedule(l, lanes[l])

    # -- event handlers ------------------------------------------------------
    def _finish_core(self, l: int, lane: _Lane, slot: int, t: float) -> _Run:
        """Per-lane finish bookkeeping.  GPU/server release is NOT done
        here — run() scatters the whole round's releases into the global
        planes at once (each lane finishes at most one run per round, so
        the (lane, server) pairs never collide and a plain fancy ``+=``
        is exact)."""
        # t_fin/order were already cleared by the batched scatter in run(),
        # and now_a / sv_a / ft_a advance in run()'s vector ops
        run = lane.slot_map[slot]
        if run.uidx is not None:
            lane.load[run.uidx] -= run.uval
            lane.dirty.append(run.uidx)
            lane.users[run.uidx, slot >> 6] &= np.uint64(
                ~(1 << (slot & 63)) & 0xFFFFFFFFFFFFFFFF)
        lane.slot_map[slot] = None
        self.next_free[l, slot] = self.free_head[l]
        self.free_head[l] = slot
        lane.finish_t[run.jidx] = t   # slowdown math deferred to _finalize
        return run

    # -- batched rate resolve (cross-lane _recompute_rates_v2) ---------------
    def _recompute(self) -> None:
        runs_all: List[_Run] = []
        vals_parts: List[np.ndarray] = []
        li_parts: List[np.ndarray] = []
        si_parts: List[np.ndarray] = []
        now_parts: List[np.ndarray] = []
        for l, lane in enumerate(self.lanes):
            if not lane.dirty:
                continue
            dirty = (lane.dirty[0] if len(lane.dirty) == 1
                     else np.concatenate(lane.dirty))
            lane.dirty.clear()
            words = np.bitwise_or.reduce(lane.users[dirty], axis=0)
            bits = np.unpackbits(words.view(np.uint8), bitorder="little")
            slots = np.flatnonzero(bits)
            if not len(slots):
                continue
            runs = [lane.slot_map[s] for s in slots]
            if len(runs) == 1:
                r0 = runs[0]
                vals_parts.append(lane.load[r0.cat_idx] - r0.cat_ucnt
                                  + r0.cat_cnt)
            else:
                idx = np.concatenate([r.cat_idx for r in runs])
                cnt = np.concatenate([r.cat_cnt for r in runs])
                ucnt = np.concatenate([r.cat_ucnt for r in runs])
                vals_parts.append(lane.load[idx] - ucnt + cnt)
            runs_all.extend(runs)
            li_parts.append(np.full(len(slots), l, dtype=np.int64))
            si_parts.append(slots)
            now_parts.append(np.full(len(slots), self.now_a[l]))
        if not runs_all:
            return
        # one CSR concat across every affected job of every lane
        vals = (vals_parts[0] if len(vals_parts) == 1
                else np.concatenate(vals_parts))
        ptrs = [np.asarray([0])]
        off = 0
        for r in runs_all:
            ptrs.append(r.pptr[1:] + off)
            off += r.pptr[-1]
        ptr = np.concatenate(ptrs)
        global solves
        solves += 1
        worst = phase_worst_loads(vals, ptr, device=self.device)
        # vectorized share -> eff -> rate -> t_fin over the affected set,
        # static per-job scalars gathered straight from the (L, S) planes
        li = np.concatenate(li_parts)
        si = np.concatenate(si_parts)
        now_arr = np.concatenate(now_parts)
        J = len(runs_all)
        nph = self.meta_nph[li, si]
        nar = self.meta_nar[li, si]
        c = self.meta_c[li, si]
        beta = self.meta_beta[li, si]
        ii = self.meta_ii[li, si]
        nb_cat = np.concatenate([r.pre.nb_arr for r in runs_all])
        pmax = int(nph.max())
        col = np.arange(pmax)
        jstart = np.r_[0, np.cumsum(nph)]
        mask = col[None, :] < nph[:, None]
        widx = np.where(mask, jstart[:-1, None] + col[None, :], 0)
        worst_pad = np.where(mask, worst[widx], 1)
        shares = 1.0 / np.maximum(worst_pad, 1)
        nb_pad = np.where(mask, nb_cat[widx], 0.0)
        # iter_effective twin: affected jobs always cross the fabric
        # (bw_mult 1), zero-padding is exact (x + 0.0 == x, t >= 0), the
        # two masked cumsums keep the AR/a2a accumulations left-to-right
        bw = self.spec.link_gbps * GBPS
        t = nb_pad / (bw * np.maximum(shares, 1e-9))
        ar_mask = col[None, :] < nar[:, None]
        t_ar = np.where(ar_mask, t, 0.0).cumsum(axis=1)[:, -1]
        t_a2a = np.where(mask & ~ar_mask, t, 0.0).cumsum(axis=1)[:, -1]
        eff = c + np.maximum(0.0, t_ar - beta * c) + t_a2a
        new = np.ones(J)
        pos = eff > 0
        new[pos] = ii[pos] / eff[pos]
        cur = self.rate[li, si]
        ch = new != cur
        if not ch.any():
            return
        li_c, si_c = li[ch], si[ch]
        nc, ii_c, new_c = now_arr[ch], ii[ch], new[ch]
        # _settle + _finish_time, only where the rate value changed
        il = self.iters_left[li_c, si_c]
        il = il - (nc - self.last_update[li_c, si_c]) * cur[ch] / ii_c
        self.iters_left[li_c, si_c] = il
        self.last_update[li_c, si_c] = nc
        self.rate[li_c, si_c] = new_c
        self.t_fin[li_c, si_c] = nc + il * ii_c / np.maximum(new_c, 1e-12)

    # -- round loop ----------------------------------------------------------
    def run(self) -> None:
        lanes = self.lanes
        inf = math.inf
        gps = self.spec.gpus_per_server
        live_idx = np.arange(len(lanes))
        while len(live_idx):
            tf = self.t_fin[live_idx]
            tmin = tf.min(axis=1)
            arr = self.arr_next[live_idx]
            t_next = np.minimum(tmin, arr)
            alive = np.isfinite(t_next)
            if not alive.all():
                for l in live_idx[~alive]:
                    lanes[l].done = True
                live_idx = live_idx[alive]
                if not len(live_idx):
                    break
                tf, tmin, arr = tf[alive], tmin[alive], arr[alive]
            # tie order matches v2: finish wins over a same-instant arrival
            is_fin = tmin <= arr
            fin_rows = np.flatnonzero(is_fin)
            if len(fin_rows):
                # per-lane (t_fin, order) argmin == the v2 heap head
                lf = live_idx[fin_rows]
                cand = tf[fin_rows] == tmin[fin_rows, None]
                ords = np.where(cand, self.order[lf], _ORDER_MAX)
                slots = np.argmin(ords, axis=1)
                self.t_fin[lf, slots] = inf      # one scatter for the whole
                self.order[lf, slots] = _ORDER_MAX   # round's finishes
                self.now_a[lf] = tmin[fin_rows]
                self.sv_a[lf] += 1
                tfin = tmin[fin_rows]
                jx = self.slot_jidx[lf, slots]
                s0 = jx >= 0
                if s0.any():
                    # plane-resident intra runs finish without touching any
                    # Python object: record, release and slot push are all
                    # grouped scatters (one finish per lane per round -> no
                    # (lane, server/gpu/slot) index ever collides)
                    lf0 = lf[s0]
                    sl0 = slots[s0]
                    self.j_fin[lf0, jx[s0]] = tfin[s0]
                    self.slot_jidx[lf0, sl0] = -1
                    srv0 = self.slot_srv[lf0, sl0]
                    cnt0 = self.slot_cnt[lf0, sl0]
                    msk0 = self.slot_mask[lf0, sl0]
                    self.server_free[lf0, srv0] += cnt0
                    bits = (msk0[:, None] >> np.arange(gps)) & 1
                    rr, cc = np.nonzero(bits)
                    self.gpu_free[lf0[rr], srv0[rr] * gps + cc] = True
                    self.ft_a[lf0] += cnt0
                    self.next_free[lf0, sl0] = self.free_head[lf0]
                    self.free_head[lf0] = sl0
                if not s0.all():
                    lf1 = lf[~s0]
                    fins: List[_Run] = []
                    for row, slot, l in zip(fin_rows[~s0], slots[~s0], lf1):
                        l = int(l)
                        fins.append(self._finish_core(
                            l, lanes[l], int(slot), float(tmin[row])))
                    gcnt = [len(r.gpus) for r in fins]
                    gl = np.concatenate([r.gpus for r in fins])
                    gr = np.repeat(lf1, gcnt)
                    self.gpu_free[gr, gl] = True
                    sl = np.concatenate([r.srv_u for r in fins])
                    sr = np.repeat(lf1, [len(r.srv_u) for r in fins])
                    self.server_free[sr, sl] += np.concatenate(
                        [r.cnt_u for r in fins])
                    self.ft_a[lf1] += np.asarray(gcnt)
            arows = live_idx[~is_fin]
            if len(arows):
                self.now_a[arows] = arr[~is_fin]
                self.qt_a[arows] += 1
                self.ai_a[arows] += 1
                # the padded extra column makes the off-end gather read inf
                self.arr_next[arows] = self.j_arr[arows, self.ai_a[arows]]
            self._schedule_lanes(live_idx)
            self._recompute()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _lane_report(lane: _Lane) -> MetricsReport:
    # identical assembly to ClusterSimulator.run() under no events/defrag
    lane._finalize()
    jobs = lane.jobs
    rep = job_metrics(jobs)
    rep.frag_gpu = sum(1 for r in lane.frag_reason.values() if r == "gpu")
    rep.frag_network = sum(1 for r in lane.frag_reason.values()
                           if r == "network")
    rep.slowdowns = [lane.slowdowns[j.job_id] for j in jobs
                     if j.job_id in lane.slowdowns]
    rep.preemptions = 0
    rep.failures = 0
    rep.resizes = 0
    rep.migrations = 0
    rep.migration_bytes = 0.0
    rep.frag_series = []
    rep.event_log = []
    return rep


def run_lanes(spec, lanes_in: Sequence[tuple],
              device=None) -> List[MetricsReport]:
    """Run many qualifying cells in lockstep.

    ``lanes_in``: sequence of ``(jobs, strategy_obj, seed)`` — ``jobs`` are
    this lane's own arrival-sorted Job copies (mutated in place, like
    ``ClusterSimulator.run``).  ``device``: where rate resolution runs,
    ``"cuda"`` (default; raises without a card) or ``"cpu"``.  Returns one
    report per lane, in order.
    """
    device = resolve_device("cuda" if device is None else device)
    if spec.is_hetero:
        # per-tier speeds / straggler scales are resolved by the v1/v2
        # engines only; a hetero spec must delegate, never run lanes
        raise ValueError(
            "heterogeneous specs do not qualify for the batched engine; "
            "run engine='batched' through ClusterSimulator (it delegates "
            "to the bit-identical v2 path) or use engine='v2' directly")
    ls = LinkSpace(spec)
    lanes = []
    for i, (jobs, strat, seed) in enumerate(lanes_in):
        # the type check matters beyond routing: e.g. vclos routes like an
        # isolated fast strategy but places via vclos_place, which this
        # engine does not replicate — letting it through would silently
        # produce wrong schedules instead of an error
        if type(strat) not in _FAST_STRATEGY_TYPES:
            raise ValueError(f"strategy {strat.name!r} does not qualify "
                             "for the batched engine")
        routing = strat.make_routing(spec, seed)
        if not _routing_qualifies(routing):   # pragma: no cover - guarded
            raise ValueError(f"strategy {strat.name!r} routing does not "
                             "qualify for the batched engine")
        pres = _pres_for(jobs, spec.link_gbps)
        lanes.append(_Lane(i, spec, ls, list(jobs), pres, routing,
                           strat.isolated))
    engine = _BatchedEngine(spec, lanes, device)
    engine.run()
    return [_lane_report(ln) for ln in lanes]


def try_run_batched(sim, jobs: List[Job],
                    max_time: float) -> Optional[MetricsReport]:
    """Fast-path dispatch for ``ClusterSimulator.run``: run ``jobs`` on the
    lane engine when the sim qualifies, else return ``None`` (caller falls
    through to the bit-identical v2 path).  ``jobs`` must already be
    arrival-sorted; they are mutated in place like the v2 run."""
    if (type(sim.strategy_obj) not in _FAST_STRATEGY_TYPES
            or not _routing_qualifies(sim.routing)
            or sim.spec.is_hetero       # speed-aware rate resolution and
            # the straggler model live in v1/v2 only — hetero specs always
            # take the bit-identical v2 path (docs/heterogeneous.md)
            or sim.scheduler != "fifo"
            or sim._events
            or not math.isinf(sim._next_defrag)
            or not math.isinf(max_time)
            or sim.running or sim.queue or sim.state.gpu_owner):
        return None
    pres = _pres_for(jobs, sim.spec.link_gbps)
    lane = _Lane(0, sim.spec, sim._ls, list(jobs), pres, sim.routing,
                 sim.isolated)
    engine = _BatchedEngine(sim.spec, [lane], sim.device)
    engine.run()
    lane._finalize()
    # mirror visible simulator state for API parity (frag accounting etc.)
    sim.frag_reason.update(lane.frag_reason)
    sim.slowdowns.update(lane.slowdowns)
    sim.now = float(engine.now_a[0])
    return _lane_report(lane)
