"""Max-min fair bandwidth allocation (water-filling), and the engines'
batched bottleneck solve.

The flow-level simulator's inner solver (RapidNetSim-style, §9.1): given a
flow×link incidence structure and per-link capacities, compute each flow's
max-min fair rate.  Classic progressive filling: repeatedly find the
bottleneck link (smallest capacity/active-flow ratio), freeze its flows at
that fair share, remove the frozen bandwidth, repeat.

Port of ``repro/core/fairshare.py``:
  * :func:`maxmin_fair_numpy` — sparse dict-based, copied as it is.
  * :func:`maxmin_fair_torch` — the dense-incidence twin of the reference's
    jitted ``_maxmin_kernel`` / ``maxmin_fair_jax``, in torch on the given
    device; its ``lax.while_loop`` is a Python loop with the same stop test.
  * :func:`phase_worst_loads` — the v2 and lane engines' per-phase worst
    link load over a CSR layout: the Hopper segment-max kernel
    (``repro_torch.kernels.phase_max``) on ``cuda``, its plain version on
    ``cpu``.  Integer in and out, so the device can never change a schedule.

The water-filling solvers return rates in the same units as capacities
(fraction of link rate when capacities are 1.0).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Hashable, List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.phase_max import check_csr, phase_max_host, phase_max_plain


def maxmin_fair_numpy(flow_links: Sequence[Sequence[Hashable]],
                      capacity: Dict[Hashable, float] | float = 1.0,
                      flow_cap: float = 1.0) -> np.ndarray:
    """Progressive filling over an explicit link list per flow.

    flow_links[i] — links used by flow i (empty ⇒ unconstrained, rate
    ``flow_cap``).  ``flow_cap`` is the per-flow rate ceiling — the
    server-NIC tier: no flow can exceed its host NIC regardless of fabric
    headroom.  The historical hard-coded ``1.0`` assumed a homogeneous
    fabric; on per-tier-speed specs derive it from the spec instead
    (``spec.nic_ratio``, docs/heterogeneous.md).  The default reproduces
    the homogeneous behaviour bit-for-bit (tests/test_hetero.py).
    """
    nflows = len(flow_links)
    rates = np.full(nflows, float(flow_cap))
    links: Dict[Hashable, List[int]] = {}
    for i, ls in enumerate(flow_links):
        for l in ls:
            links.setdefault(l, []).append(i)
    if not links:
        return rates
    cap = {l: (capacity if isinstance(capacity, (int, float))
               else capacity.get(l, 1.0)) for l in links}
    remaining = dict(cap)
    active = {l: set(fs) for l, fs in links.items()}
    frozen = np.zeros(nflows, dtype=bool)
    # flows with no links are unconstrained
    for i, ls in enumerate(flow_links):
        if not ls:
            frozen[i] = True
    while True:
        # bottleneck link = min remaining/|active|
        best, best_share = None, np.inf
        for l, fs in active.items():
            if not fs:
                continue
            share = remaining[l] / len(fs)
            if share < best_share - 1e-15:
                best, best_share = l, share
        if best is None:
            break
        share = min(best_share, flow_cap)  # NIC-bounded: flow ≤ its NIC rate
        for i in list(active[best]):
            rates[i] = share
            frozen[i] = True
            for l in flow_links[i]:
                if i in active.get(l, ()):  # remove from all its links
                    active[l].discard(i)
                    remaining[l] -= share
        if share >= flow_cap:
            # everything else is also NIC-limited; clamp and exit
            rates[~frozen] = flow_cap
            break
    return np.clip(rates, 0.0, flow_cap)


def _maxmin_loop(incidence: torch.Tensor, cap: torch.Tensor,
                 flow_cap: float) -> torch.Tensor:
    """Twin of the reference's ``_maxmin_kernel``.  incidence: (links,
    flows) 0/1 float32; cap: (links,) float32; flow_cap: per-flow ceiling
    (the NIC tier).  Returns (flows,) float32 on the incidence's device."""
    nlinks, nflows = incidence.shape
    dev = incidence.device
    fcap = torch.tensor(flow_cap, dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    rates = torch.full((nflows,), flow_cap, dtype=torch.float32, device=dev)
    frozen = (incidence.sum(dim=0) == 0).to(torch.float32)
    remaining = cap.to(torch.float32)
    for _ in range(nlinks + 1):          # the reference's iteration cap
        act = incidence * (1.0 - frozen)[None, :]
        if not bool(act.sum() > 0):      # its stop test: no active flow
            break
        nact = act.sum(dim=1)
        share = torch.where(nact > 0, remaining / torch.clamp(nact, min=1),
                            inf)
        share = torch.minimum(share, fcap)
        b = torch.argmin(share)          # first minimum, as jnp.argmin
        s = share[b]
        hit = act[b] > 0                 # flows on the bottleneck link
        done = torch.logical_not(hit.any())
        new_rates = torch.where(hit, s, rates)
        new_frozen = torch.where(hit, torch.ones_like(frozen), frozen)
        # subtract frozen bandwidth from every link these flows touch
        used = (incidence * hit[None, :]).sum(dim=1) * s
        rates = torch.where(done, rates, new_rates)
        frozen = torch.where(done, frozen, new_frozen)
        remaining = torch.where(done, remaining, remaining - used)
    return torch.clamp(rates, 0.0, flow_cap)


def maxmin_fair_torch(flow_links: Sequence[Sequence[Hashable]],
                      capacity: Dict[Hashable, float] | float = 1.0,
                      flow_cap: float = 1.0, device=None) -> np.ndarray:
    """Dense-incidence water-filling on ``device`` (``"cuda"`` by default;
    raises without a card) — the twin of the reference's
    ``maxmin_fair_jax``.  ``flow_cap`` as in :func:`maxmin_fair_numpy`."""
    dev = resolve_device("cuda" if device is None else device)
    nflows = len(flow_links)
    link_ids: Dict[Hashable, int] = {}
    for ls in flow_links:
        for l in ls:
            link_ids.setdefault(l, len(link_ids))
    if not link_ids:
        return np.full(nflows, float(flow_cap))
    inc = np.zeros((len(link_ids), nflows), dtype=np.float32)
    for i, ls in enumerate(flow_links):
        for l in ls:
            inc[link_ids[l], i] = 1.0
    if isinstance(capacity, (int, float)):
        cap = np.full(len(link_ids), float(capacity), dtype=np.float32)
    else:
        cap = np.array([capacity.get(l, 1.0) for l in link_ids],
                       dtype=np.float32)
    out = _maxmin_loop(torch.from_numpy(inc).to(dev),
                       torch.from_numpy(cap).to(dev), float(flow_cap))
    return out.cpu().numpy()


def maxmin_fair(flow_links, capacity=1.0, backend: str = "numpy",
                flow_cap: float = 1.0, device=None) -> np.ndarray:
    """``backend``: ``"numpy"`` (default), ``"torch"`` (the dense solver on
    ``device``) or ``"auto"`` (size-dispatched, :func:`maxmin_fair_auto`)."""
    if backend == "torch":
        return maxmin_fair_torch(flow_links, capacity, flow_cap, device)
    if backend == "auto":
        return maxmin_fair_auto(flow_links, capacity, flow_cap, device)
    return maxmin_fair_numpy(flow_links, capacity, flow_cap)


# ---------------------------------------------------------------------------
# Auto-dispatch: numpy for small solves, the dense torch solver above an
# auto-tuned crossover size.  "Size" is the dense incidence entry count
# (flows × distinct links) — what the dense solver actually materialises.
# ---------------------------------------------------------------------------

#: Below this dense size the numpy path always wins (and the auto path never
#: pays a warm-up); above it the measured crossover decides.
AUTOTUNE_FLOOR = 1 << 16

_CROSSOVER_ENV = "REPRO_MAXMIN_CROSSOVER"
_crossover: Dict[str, float] = {}          # {device: size} once resolved


def problem_size(flow_links: Sequence[Sequence[Hashable]]) -> int:
    """Dense incidence entries of one max-min problem (flows × links)."""
    links = set()
    for ls in flow_links:
        links.update(ls)
    return len(flow_links) * len(links)


def _bench_once(fn, flow_links) -> float:
    fn(flow_links)                         # warm (allocator, first launch)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn(flow_links)
        best = min(best, time.perf_counter() - t0)
    return best


def autotune_crossover(probe_flows: Sequence[int] = (64, 256, 1024, 4096),
                       nlinks: int = 64, seed: int = 0,
                       device=None) -> float:
    """Measure numpy vs the torch water-filling on ``device`` over growing
    problem sizes and return the smallest dense size where the torch solver
    wins (``inf`` when it never does).  ``maxmin_crossover`` caches the
    result per device; ``REPRO_MAXMIN_CROSSOVER`` overrides it."""
    dev = resolve_device("cuda" if device is None else device)
    rng = np.random.default_rng(seed)
    crossover = float("inf")
    for nflows in probe_flows:
        flow_links = [rng.choice(nlinks, size=3, replace=False).tolist()
                      for _ in range(nflows)]
        t_np = _bench_once(maxmin_fair_numpy, flow_links)
        t_tc = _bench_once(lambda fl: maxmin_fair_torch(fl, device=dev),
                           flow_links)
        if t_tc < t_np:
            crossover = problem_size(flow_links)
            break
    return crossover


def maxmin_crossover(device=None) -> float:
    """Resolved numpy→torch crossover size on ``device`` (env override >
    cached autotune)."""
    dev = resolve_device("cuda" if device is None else device)
    key = str(dev)
    if key not in _crossover:
        env = os.environ.get(_CROSSOVER_ENV)
        if env is not None:
            _crossover[key] = float(env)
        else:
            _crossover[key] = autotune_crossover(device=dev)
    return _crossover[key]


def maxmin_fair_auto(flow_links: Sequence[Sequence[Hashable]],
                     capacity: Dict[Hashable, float] | float = 1.0,
                     flow_cap: float = 1.0, device=None) -> np.ndarray:
    """Size-dispatched max-min: sparse numpy below the crossover, the dense
    torch solver on ``device`` above it.  Both solvers agree to float32
    resolution."""
    size = problem_size(flow_links)
    if size < AUTOTUNE_FLOOR or size < maxmin_crossover(device):
        return maxmin_fair_numpy(flow_links, capacity, flow_cap)
    return maxmin_fair_torch(flow_links, capacity, flow_cap, device)


# ---------------------------------------------------------------------------
# Batched bottleneck solve for the v2 and lane engines: per-phase worst link
# load over a CSR-style (values, row-pointer) layout.  Integer in/out, so
# the kernel, its plain version and numpy are bit-identical by construction
# and the engines' schedules cannot depend on the device.
# ---------------------------------------------------------------------------

def phase_worst_numpy(vals: np.ndarray, ptr: np.ndarray) -> np.ndarray:
    """``out[i] = max(vals[ptr[i]:ptr[i+1]])`` (0 for empty segments)."""
    nseg = len(ptr) - 1
    out = np.zeros(nseg, dtype=np.int64)
    if not len(vals):
        return out
    width = np.diff(ptr)
    nonempty = width > 0
    if nonempty.any():
        # reduceat over non-empty starts only: each reduction spans to the
        # next non-empty start, absorbing the interleaved empty segments
        # (which contribute nothing) — sidesteps reduceat's empty-segment
        # misbehaviour (it would return vals[ptr[i]])
        out[nonempty] = np.maximum.reduceat(vals, ptr[:-1][nonempty])
    return out


def phase_worst_loads(vals: np.ndarray, ptr: np.ndarray,
                      device=None) -> np.ndarray:
    """Batched per-phase bottleneck loads — the contended-subgraph solve of
    the v2/lane engines' rate resolution: ``out[i] = max(vals[ptr[i]:
    ptr[i+1]])``, 0 for an empty segment, as int64 numpy.

    On ``cuda`` (the default; raises without a card) every call runs the
    segment-max kernel through :func:`repro_torch.kernels.phase_max.
    phase_max_host`: one host copy into a page-locked staging buffer that
    the kernel reads in place, one launch, one wait; on ``cpu`` it runs the
    kernel's plain version.  ``ptr`` is checked on the host first (starts
    at 0, ends at ``len(vals)``, monotone).
    """
    dev = resolve_device("cuda" if device is None else device)
    vals, ptr = np.asarray(vals), np.asarray(ptr)
    for name, a in (("vals", vals), ("ptr", ptr)):
        if a.ndim != 1 or a.dtype.kind not in "iu":   # integer dtypes
            raise TypeError(f"phase_worst_loads: {name} must be a 1-D integer "
                            f"array, got {a.dtype} of shape {a.shape}")
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    ptr = np.ascontiguousarray(ptr, dtype=np.int64)
    check_csr(ptr, len(vals))
    if dev.type == "cuda":
        return phase_max_host(vals, ptr, dev)
    if dev.type != "cpu":
        raise ValueError(f"phase_worst_loads: no path for device {dev}")
    return phase_max_plain(torch.from_numpy(vals),
                           torch.from_numpy(ptr)).numpy()
