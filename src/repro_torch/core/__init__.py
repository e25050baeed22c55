"""Port of ``repro.core``: the vClos scheduler and its flow-level simulator.

The numpy core is the port's own copy of the reference's modules (it imports
nothing of ``repro``); ``fairshare`` carries the torch twin of the JAX
water-filling solver and the engines' rate resolution, which runs the
Hopper segment-max kernel (``repro_torch.kernels.phase_max``) on ``cuda``.

Layers:
  topology   — Leaf-Spine fabric + OCS layer state
  traffic    — collective traffic pattern generators (+ executable oracles)
  routing    — Source Routing / ECMP / Balanced ECMP + contention accounting
  patterns   — Leaf-wise Permutation (Definition 1) checker
  placement  — vClos stages 0-2 + FINDVCLOS ILP (Algorithm 1/3)
  ocs        — OCS-vClos stages + rewiring planner (Algorithm 2/4)
  strategies — pluggable Strategy registry (builtins + contention-affinity)
  config     — SimConfig: unified simulate() configuration
  events     — dynamic cluster events (preempt/fail/resize) + frag index
  fairshare  — max-min fair water-filling (numpy + torch) and the batched
               per-phase worst-load solve (segment-max kernel)
  jobs       — DML workload profiles + dataset generators
  workloads  — reproducible Poisson/CSV arrival traces and churn events
  traces     — real-trace ingestion: adapters, streaming reader, windows
  simulator  — event-driven flow-level cluster simulator (v1 / v2 engines)
  batched    — lane-batched lockstep engine (``engine="batched"``,
               ``run_lanes``)
  runtime    — fault-tolerant cell execution: retries, timeouts, journal
  campaign   — strategy × policy × load × seed sweeps + aggregation
  figures    — the paper's figures as deterministic tables
  scheduler  — online scheduler facade
  metrics    — JRT / JWT / JCT / Stability (+ CDF helpers)
  rankmap    — vClos placement -> leaf-contiguous rank and device order

Entry points that take ``device`` (``simulate``, ``ClusterSimulator``,
``run_lanes``, ``run_campaign``, ``run_windowed_campaign``,
``build_figure``, ``build_all``, ``phase_worst_loads``,
``maxmin_fair_torch``) run on ``cuda`` unless given
``device="cpu"``, and raise where there is no card.
"""

from .topology import (CLUSTER512, CLUSTER512_OCS, CLUSTER2048,
                       CLUSTER2048_OCS, TESTBED32, ClusterSpec, FabricState,
                       OCSLayer, apply_gpu_mix)
from .traffic import (Flow, double_binary_tree_allreduce,
                      halving_doubling_allreduce, hierarchical_ring_allreduce,
                      pairwise_alltoall, pipeline_p2p, ring_allreduce)
from .routing import (BalancedECMPRouting, ContentionReport, ECMPRouting,
                      IdealRouting, SourceRouting, contention,
                      contention_histogram)
from .patterns import (all_phases_leafwise, comm_duty_cycle, duty_overflow,
                       is_leafwise_permutation)
from .placement import (Placement, PlacementFailure, VirtualClos, commit,
                        find_vclos, release, stage0_server, stage1_leaf,
                        vclos_place)
from .ocs import (RewirePlanner, collect_idle_servers, ocs_release,
                  ocs_vclos_place)
from .fairshare import (maxmin_fair, maxmin_fair_auto, maxmin_fair_numpy,
                        maxmin_fair_torch, phase_worst_loads,
                        phase_worst_numpy)
from .jobs import (BATCHES, PROFILES, Job, ModelProfile, cluster_dataset,
                   testbed_dataset, weighted_choice, HELIOS_SIZE_MIX,
                   TPUV4_SIZE_MIX)
from .events import (EVENT_KINDS, ClusterEvent, frag_index, validate_events)
from .workloads import (SIZE_MIXES, WorkloadSpec, generate_events,
                        generate_trace, load_trace_csv, poisson_trace,
                        save_trace_csv, trace_stats)
from .metrics import MetricsReport, cdf, cdf_table, job_metrics
from .strategies import (Strategy, get_strategy, register_strategy,
                         registered_strategies, strategy_names,
                         unregister_strategy)
from .config import ENGINES, STORES, SimConfig
from .runtime import (CampaignError, CellJournal, CellOutcome, CellRunner,
                      FailedCell, JournalMismatch, atomic_write_bytes,
                      atomic_write_text, backoff_delay, classify_exception,
                      trace_fingerprint)
from .simulator import STRATEGIES, ClusterSimulator, simulate
from .batched import run_lanes
from .traces import (ADAPTERS, TRACE_FORMATS, AlibabaAdapter,
                     GenericCSVAdapter, JobIdInterner, NativeCSVAdapter,
                     TraceAdapter, TraceFormatError, TraceSource,
                     TraceSummary, TraceWindow, detect_format,
                     empirical_size_mix, fit_workload, iter_windows,
                     iters_for_duration, stable_model_for, summarize_jobs)
from .campaign import (AGGREGATE_COLUMNS, CampaignGrid, CampaignResult,
                       CellResult, run_campaign, run_windowed_campaign)
from .figures import (FIGURES, FigureSpec, FigureTable, build_all,
                      build_figure, figure_names, qualitative_checks)
from .scheduler import (Grant, IsolatedScheduler, QUEUE_POLICIES, order_queue)
from .rankmap import leaf_contiguous_order, mesh_device_order
