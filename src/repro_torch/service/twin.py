"""What-if digital twin: fork the live cluster, predict, never commit.

The port's copy of the reference's ``service/twin.py``.

A *what-if* query asks: "if this job were submitted right now, what JCT
would it see — and what would it do to everyone else?"  The twin answers
by forking the live v2 engine (a copy-on-fork deep snapshot: the running
set, completion heap, link-load vectors, and queue all come along, so the
fork's future is exactly the live cluster's future) and stepping the fork
over a bounded horizon with :func:`~repro_torch.service.state.drain_completions`
— the same loop the live state itself uses.

Per candidate strategy the fork swaps placement machinery (strategy
object, routing, failure-memo policy) before placing the probe.  Jobs
already running keep the placements and link accounting the *live*
strategy gave them — you cannot re-route a running collective — so a
cross-strategy what-if reads as "probe placed by X into a cluster run by
Y", which is precisely the admission decision an operator faces.  Rate
recomputation stays enabled whenever either side has fabric flows
(``isolated`` is only the candidate's during the probe build), so
predictions never freeze a contended job's rate.

Answers are **memoised by fabric version**: the
:class:`~repro_torch.service.state.LiveCluster` bumps its version on every
observable mutation (submit, churn event, completion, clock movement), so
a cache hit is provably current and any mutation forces a recompute
(``tests/test_torch_service.py`` pins both directions).  Baseline horizon
runs (fork without the probe) are shared across candidate strategies at the
same version.

A fork solves on the live cluster's device: the simulator holds no tensor,
only its (immutable) ``torch.device``, which the fork shares; the kernel's
page-locked staging belongs to the kernel module, not to a simulator.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple

from ..core.jobs import Job
from ..core.strategies import get_strategy
from .state import PROBE_ID_BASE, LiveCluster, drain_completions

__all__ = ["DigitalTwin"]

#: default prediction horizon (virtual seconds past "now")
DEFAULT_HORIZON = 200_000.0


class DigitalTwin:
    """Memoised what-if query engine over one :class:`LiveCluster`."""

    def __init__(self, live: LiveCluster,
                 default_horizon: float = DEFAULT_HORIZON):
        self.live = live
        self.default_horizon = default_horizon
        # (job-signature, strategies, horizon) -> (fabric_version, answer)
        self._memo: Dict[tuple, Tuple[int, Dict]] = {}
        # (fabric_version, horizon) -> {job_id: predicted finish}
        self._baselines: Dict[Tuple[int, float], Dict[int, float]] = {}
        self._probe_counter = 0
        self.forks = 0      # deep snapshots taken (tests count these)
        self.hits = 0
        self.misses = 0

    # -- forking ------------------------------------------------------------
    def fork(self):
        """Copy-on-fork snapshot of the live engine.  Immutable members
        (spec, config, the stateless strategy instance, the device) are
        shared via the deepcopy memo; everything mutable — jobs, heap,
        occupancy arrays, routing — is copied, so stepping the fork can
        never leak into the live cluster."""
        sim = self.live.sim
        memo = {id(sim.spec): sim.spec, id(sim.config): sim.config,
                id(sim.strategy_obj): sim.strategy_obj,
                id(sim.device): sim.device}
        self.forks += 1
        return copy.deepcopy(sim, memo)

    # -- baseline: the forked future without the probe ----------------------
    def _baseline(self, horizon: float) -> Dict[int, float]:
        key = (self.live.version, horizon)
        hit = self._baselines.get(key)
        if hit is not None:
            return hit
        fork = self.fork()
        done = drain_completions(fork, fork.now + horizon)
        base = dict(done)
        # one fabric version in the cache at a time: stale entries can
        # never be read again (version only grows), so drop them
        self._baselines = {k: v for k, v in self._baselines.items()
                           if k[0] == self.live.version}
        self._baselines[key] = base
        return base

    # -- the query ----------------------------------------------------------
    def whatif(self, model: str, num_gpus: int, num_iters: int,
               batch_size: Optional[int] = None,
               allreduce_algo: str = "ring",
               strategies: Optional[Sequence[str]] = None,
               horizon: Optional[float] = None) -> Dict:
        """Predict the fate of a candidate job under each candidate
        placement strategy.  Returns per-strategy predictions plus the
        fabric version they are valid for; served from the memo when the
        version has not moved since the identical query."""
        horizon = float(horizon if horizon is not None
                        else self.default_horizon)
        if not (horizon > 0):
            raise ValueError(f"horizon must be > 0 (got {horizon})")
        names = tuple(strategies) if strategies \
            else (self.live.sim.strategy,)
        key = ((model, int(num_gpus), int(num_iters), batch_size,
                allreduce_algo), names, horizon)
        cached = self._memo.get(key)
        if cached is not None and cached[0] == self.live.version:
            self.hits += 1
            return {**cached[1], "cached": True}
        self.misses += 1
        version = self.live.version
        baseline = self._baseline(horizon)
        answer = {"fabric_version": version, "now": self.live.now,
                  "horizon": horizon, "cached": False,
                  "strategies": {name: self._evaluate(
                      name, model, num_gpus, num_iters, batch_size,
                      allreduce_algo, horizon, baseline)
                      for name in names}}
        self._memo = {k: v for k, v in self._memo.items()
                      if v[0] == version}
        self._memo[key] = (version, answer)
        return answer

    def _probe_job(self, model: str, num_gpus: int, num_iters: int,
                   batch_size: Optional[int], allreduce_algo: str,
                   arrival: float) -> Job:
        from ..core.jobs import BATCHES, PROFILES
        if model not in PROFILES:
            raise ValueError(f"unknown model {model!r}; "
                             f"choose from {sorted(PROFILES)}")
        if batch_size is None:
            batch_size = BATCHES.get(model, (32,))[0]
        self._probe_counter += 1
        return Job(job_id=PROBE_ID_BASE + self._probe_counter, model=model,
                   num_gpus=int(num_gpus), batch_size=int(batch_size),
                   arrival=arrival, num_iters=int(num_iters),
                   allreduce_algo=allreduce_algo)

    def _evaluate(self, name: str, model: str, num_gpus: int,
                  num_iters: int, batch_size: Optional[int],
                  allreduce_algo: str, horizon: float,
                  baseline: Dict[int, float]) -> Dict:
        strat = get_strategy(name)
        live_sim = self.live.sim
        if strat.requires_ocs and not live_sim.spec.num_ocs:
            return {"supported": False,
                    "reason": f"strategy {name!r} needs an OCS-equipped "
                              f"cluster (spec.num_ocs > 0)"}
        if live_sim.scheduler not in strat.queue_policies:
            return {"supported": False,
                    "reason": f"strategy {name!r} does not support the "
                              f"live queueing policy "
                              f"{live_sim.scheduler!r}"}
        fork = self.fork()
        live_isolated = fork.isolated
        if name != fork.strategy:
            fork.strategy_obj = strat
            fork.strategy = strat.name
            fork.routing = strat.make_routing(fork.spec, fork.seed)
            fork._memoize_failures = strat.memoize_failures
            fork._fail_version = {}   # memoised failures were for the
            #                           live strategy's placement function
        t0 = fork.now
        probe = self._probe_job(model, num_gpus, num_iters, batch_size,
                                allreduce_algo, arrival=t0)
        fork._jobs_by_id[probe.job_id] = probe
        fork.queue.append(probe)
        # the candidate's isolation governs the probe's *build* (whether
        # its flows get link accounting); stepping reverts to "isolated
        # only if nobody has fabric flows", so existing contended jobs
        # keep re-solving their rates after every completion
        fork.isolated = strat.isolated
        fork._try_schedule_v2()
        fork.isolated = live_isolated and strat.isolated
        fork._recompute_rates_v2()
        placed_now = probe.job_id in fork.running
        out: Dict = {"supported": True, "placed_now": placed_now}
        if placed_now:
            p = fork.running[probe.job_id].placement
            out["kind"] = p.kind
            out["gpus"] = list(p.gpus)
        elif probe.job_id in fork.frag_reason:
            out["blocked_on"] = fork.frag_reason[probe.job_id]
        done = dict(drain_completions(fork, t0 + horizon))
        probe_fin = done.get(probe.job_id)
        out["finished_within_horizon"] = probe_fin is not None
        out["predicted_wait"] = (probe.start_time - t0
                                 if probe.start_time is not None else None)
        out["predicted_jct"] = (probe_fin - t0
                                if probe_fin is not None else None)
        # contention delta: how much the probe displaces everyone already
        # in the system, over jobs whose predicted finish falls inside the
        # horizon both with and without it
        deltas = [done[j] - t for j, t in baseline.items() if j in done]
        out["n_delta_jobs"] = len(deltas)
        out["contention_delta_mean"] = (
            sum(deltas) / len(deltas) if deltas else 0.0)
        out["contention_delta_max"] = max(deltas) if deltas else 0.0
        return out

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict:
        return {"hits": self.hits, "misses": self.misses,
                "forks": self.forks, "memo_size": len(self._memo),
                "default_horizon": self.default_horizon}
