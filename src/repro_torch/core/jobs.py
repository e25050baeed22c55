"""DML job model: workloads, communication profiles, dataset generators.

Calibration follows the paper:
  * Testbed workloads (§8.1, Table 3): VGG16, ResNet50/101, BERT (data
    parallel, Ring/hierarchical-Ring/HD allreduce) plus MoE and DLRM
    (pairwise AlltoAll) at the paper's mini-batch sizes.
  * Per-iteration time model (§3.3 observations): allreduce overlaps with
    backward compute (coverable fraction), AlltoAll sits on the critical
    path (uncoverable), so
        iter(share) = C + max(0, AR/(bw·share) − β·C) + A2A/(bw·share)
    which reproduces the paper's findings that (1) big-parameter models are
    sensitive, (2) larger batch ⇒ less sensitive, (3) AlltoAll models are
    most sensitive, (4) sensitivity is non-linear in the contention level.
  * Job-size mixes for the Helios-based CLUSTER512/2048 datasets (§9.2) and
    the TPUv4-style large-job mix (§9.8, Table 7).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import traffic
from .traffic import Flow, Phase

GBPS = 1e9 / 8  # bytes per second per Gbps


@dataclass(frozen=True)
class ModelProfile:
    """Static communication/compute profile of one workload family."""

    name: str
    param_bytes: float            # gradient bytes per allreduce
    compute_ref: float            # seconds/iter at batch_ref on one V100
    batch_ref: int
    alltoall_bytes: float = 0.0   # bytes per GPU per iteration (MoE/DLRM)
    overlap_beta: float = 0.67    # fraction of compute that can hide AR
    allreduce_algos: Tuple[str, ...] = ("ring", "hierarchical_ring", "hd")


# Profiles sized from public model cards; compute_ref ~ V100 throughputs.
# AlltoAll volumes are calibrated so two-flow contention reproduces the
# paper's Fig. 6 throughput drops (MoE/DLRM ≈ -35..50%, VGG16 ≈ -35%,
# BERT ≈ -30%, ResNets nearly insensitive).
PROFILES: Dict[str, ModelProfile] = {
    "vgg16":     ModelProfile("vgg16", 552e6, 0.128, 32),
    "resnet50":  ModelProfile("resnet50", 102e6, 0.100, 32),
    "resnet101": ModelProfile("resnet101", 178e6, 0.170, 32),
    "bert":      ModelProfile("bert", 1.36e9, 0.360, 4),
    "moe":       ModelProfile("moe", 200e6, 0.070, 8, alltoall_bytes=1.2e9),
    "dlrm":      ModelProfile("dlrm", 25e6, 0.015, 256, alltoall_bytes=0.85e9),
}

# Table 3 mini-batch sets
BATCHES: Dict[str, Tuple[int, ...]] = {
    "vgg16": (16, 32), "resnet50": (32, 64), "resnet101": (32, 64),
    "bert": (4, 8), "moe": (8, 16), "dlrm": (256, 512),
}


@dataclass
class Job:
    job_id: int
    model: str
    num_gpus: int
    batch_size: int
    arrival: float
    num_iters: int
    allreduce_algo: str = "ring"
    deadline: Optional[float] = None
    # filled during simulation
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    # carried across preemption / failure / resize restarts: the settled
    # remaining work (iterations) plus any checkpoint-restart penalty;
    # None means the job has never been interrupted (fresh placements run
    # the full num_iters — the pre-events behaviour, bit-for-bit)
    remaining_iters: Optional[float] = None

    @property
    def profile(self) -> ModelProfile:
        return PROFILES[self.model]

    # -- per-iteration time model ------------------------------------------
    def compute_time(self) -> float:
        p = self.profile
        return p.compute_ref * self.batch_size / p.batch_ref

    def comm_bytes(self) -> Tuple[float, float]:
        """(ring-equivalent allreduce bytes per GPU, alltoall bytes per GPU)."""
        p = self.profile
        n = self.num_gpus
        ar = 2.0 * p.param_bytes * (n - 1) / n if n > 1 else 0.0
        a2a = p.alltoall_bytes * (n - 1) / n if n > 1 else 0.0
        return ar, a2a

    def iter_time(self, share: float, link_gbps: float = 100.0) -> float:
        """Iteration latency at a given max-min fair bandwidth share."""
        c = self.compute_time()
        if self.num_gpus == 1:
            return c
        bw = link_gbps * GBPS * max(share, 1e-9)
        ar, a2a = self.comm_bytes()
        t_ar = ar / bw
        t_a2a = a2a / bw
        uncovered_ar = max(0.0, t_ar - self.profile.overlap_beta * c)
        return c + uncovered_ar + t_a2a

    def ideal_runtime(self, link_gbps: float = 100.0) -> float:
        return self.num_iters * self.iter_time(1.0, link_gbps)

    # -- traffic -------------------------------------------------------------
    def phases(self, ranks: Sequence[int]) -> List[Tuple[str, Phase]]:
        """Representative concurrent phases over physical GPU ids ``ranks``,
        tagged ("ar" | "a2a").  Phase flow sizes carry the *total* bytes the
        flow moves across the whole collective so one representative phase
        stands for all identical rounds (ring) while multi-step collectives
        (HD, AlltoAll) keep one phase per distinct pattern."""
        return self.ar_phases(ranks) + self.a2a_phases(ranks)

    def ar_phases(self, ranks: Sequence[int]) -> List[Tuple[str, Phase]]:
        """The allreduce phases of :meth:`phases` (split out so the
        simulator can synthesise AlltoAll link loads without materialising
        every per-step Flow object)."""
        ar, _ = self.comm_bytes()
        p = self.profile
        out: List[Tuple[str, Phase]] = []
        if len(ranks) < 2:
            return out
        n = len(ranks)
        if ar > 0:
            if self.allreduce_algo == "hd":
                # per-phase halving sizes; Σ phase bytes ≈ ar (same volume)
                out.extend(("ar", ph) for ph in
                           traffic.halving_doubling_allreduce(ranks, p.param_bytes))
            elif self.allreduce_algo == "hierarchical_ring":
                # intra-server rings ride NVLink (local, dropped from fabric
                # accounting); the leader ring carries the full gradient.
                group = 8
                leaders = [ranks[i] for i in range(0, n, group)] \
                    if n > group and n % group == 0 else list(ranks)
                m = len(leaders)
                out.append(("ar", [Flow(leaders[i], leaders[(i + 1) % m],
                                        2.0 * p.param_bytes * (m - 1) / max(m, 1))
                                   for i in range(m)] if m > 1 else []))
            else:
                # all 2(n-1) ring rounds share one pattern — collapse into a
                # single phase whose per-flow bytes are the whole AR volume
                out.append(("ar", [Flow(ranks[i], ranks[(i + 1) % n], ar)
                                   for i in range(n)]))
        return out

    def ar_phase_arrays(self, ranks: Sequence[int]):
        """Vectorized twin of :meth:`ar_phases`: per-phase ``(kind, nbytes)``
        metadata plus concatenated ``(src, dst, phase_idx)`` GPU-id arrays,
        mirroring the Flow-level generators exactly (same phases, same flow
        sets, same per-flow byte counts) without materialising Flow objects.
        """
        ar, _ = self.comm_bytes()
        p = self.profile
        metas: List[Tuple[str, float]] = []
        srcs: List[np.ndarray] = []
        dsts: List[np.ndarray] = []
        n = len(ranks)
        empty = (np.empty(0, dtype=np.int64),) * 3
        if n < 2 or ar <= 0:
            return metas, *empty
        r = np.asarray(ranks, dtype=np.int64)
        if self.allreduce_algo == "hd":
            pow2 = 1 << int(math.floor(math.log2(n)))
            extra = n - pow2
            if extra:  # pre-fold: rank i -> rank i + pow2
                metas.append(("ar", p.param_bytes))
                srcs.append(r[:extra])
                dsts.append(r[pow2:])
            core = r[extra:]
            idx = np.arange(pow2)
            sz = p.param_bytes / 2
            steps = int(math.log2(pow2))
            for t in range(steps):           # reduce-scatter, halving
                metas.append(("ar", sz))
                srcs.append(core)
                dsts.append(core[idx ^ (1 << t)])
                sz /= 2
            sz = p.param_bytes / pow2
            for t in reversed(range(steps)):  # all-gather, doubling
                metas.append(("ar", sz))
                srcs.append(core)
                dsts.append(core[idx ^ (1 << t)])
                sz *= 2
            if extra:  # post-fold back
                metas.append(("ar", p.param_bytes))
                srcs.append(r[pow2:])
                dsts.append(r[:extra])
        elif self.allreduce_algo == "hierarchical_ring":
            group = 8
            leaders = (r[::group] if n > group and n % group == 0 else r)
            m = len(leaders)
            if m > 1:
                metas.append(("ar", 2.0 * p.param_bytes * (m - 1) / m))
                srcs.append(leaders)
                dsts.append(np.concatenate([leaders[1:], leaders[:1]]))
            else:
                metas.append(("ar", 0.0))
        else:  # ring: one collapsed phase carrying the whole AR volume
            metas.append(("ar", ar))
            srcs.append(r)
            dsts.append(np.concatenate([r[1:], r[:1]]))
        if not srcs:
            return metas, *empty
        phase_idx = np.repeat(np.arange(len(srcs), dtype=np.int64),
                              [len(s) for s in srcs])
        return metas, np.concatenate(srcs), np.concatenate(dsts), phase_idx

    def a2a_phases(self, ranks: Sequence[int]) -> List[Tuple[str, Phase]]:
        """The AlltoAll phases of :meth:`phases` (N-1 pairwise steps)."""
        _, a2a = self.comm_bytes()
        if len(ranks) < 2 or a2a <= 0:
            return []
        return [("a2a", ph) for ph in
                traffic.pairwise_alltoall(ranks, self.profile.alltoall_bytes)]


# ---------------------------------------------------------------------------
# Dataset generators — the fixed paper datasets. For parameterised /
# CSV-backed campaign traces see ``repro_torch.core.workloads``.
# ---------------------------------------------------------------------------

def weighted_choice(rng: np.random.Generator, items, probs):
    """One draw from ``items`` with (unnormalised) weights ``probs``."""
    return items[rng.choice(len(items), p=np.asarray(probs) / np.sum(probs))]


_choice = weighted_choice  # internal alias kept for draw-order parity


def testbed_dataset(num_jobs: int = 100, seed: int = 0,
                    mean_interarrival: float = 15.0) -> List[Job]:
    """§8.1 testbed set: 100 jobs, N ∈ {2,4,8,16}, Table-3 batches,
    duration scale tuned so Avg.JRT lands in the paper's 70-100 s band and
    the queue stays loaded (Table 4's JWT regime)."""
    rng = np.random.default_rng(seed)
    models = list(PROFILES)
    jobs: List[Job] = []
    t = 0.0
    for i in range(num_jobs):
        model = models[rng.integers(len(models))]
        n = int(_choice(rng, [2, 4, 8, 16], [0.3, 0.3, 0.25, 0.15]))
        batch = int(BATCHES[model][rng.integers(len(BATCHES[model]))])
        algo = ["ring", "hierarchical_ring", "hd"][rng.integers(3)]
        iters = int(rng.lognormal(mean=5.8, sigma=0.5))
        t += rng.exponential(mean_interarrival)
        jobs.append(Job(i, model, n, batch, t, max(iters, 40),
                        allreduce_algo=algo))
    return jobs


HELIOS_SIZE_MIX: List[Tuple[int, float]] = [
    (1, 0.22), (2, 0.14), (4, 0.14), (8, 0.16),
    (16, 0.12), (32, 0.09), (64, 0.06), (96, 0.03),
    (128, 0.02), (160, 0.015), (256, 0.005),
]

TPUV4_SIZE_MIX: List[Tuple[int, float]] = [
    (32, 0.18), (64, 0.27), (128, 0.27), (256, 0.19), (512, 0.09),
]


def cluster_dataset(num_jobs: int = 5000, lam: float = 120.0, seed: int = 0,
                    size_mix: Optional[List[Tuple[int, float]]] = None,
                    max_gpus: Optional[int] = None,
                    with_deadlines: bool = False) -> List[Job]:
    """Helios-derived mix (§9.2): Poisson arrivals with mean gap ``lam``.

    Thin wrapper over ``workloads.generate_trace`` (one copy of the draw
    sequence).  The lognormal(8.8, 1.1) durations are tuned so the offered
    load at the paper's λ=120s sits just below saturation for `best`
    (ρ≈0.9) — the regime where ECMP's contention slowdown tips the queue
    over (§9.4).
    """
    from .workloads import WorkloadSpec, generate_trace
    return generate_trace(WorkloadSpec(
        num_jobs=num_jobs, mean_interarrival=lam, seed=seed,
        size_mix=tuple((int(s), float(p)) for s, p in size_mix)
        if size_mix is not None else "helios",
        max_gpus=max_gpus,
        deadline_slack=(1.5, 4.0) if with_deadlines else None))
