"""``schedd`` — the online scheduler daemon CLI (the port's copy).

    python -m repro_torch.launch.schedd serve   --cluster 512 --strategy sr \\
                                                --port 5999 \\
                                                --event-log sched.log
    python -m repro_torch.launch.schedd submit  --port 5999 \\
                                                --model resnet50 \\
                                                --num-gpus 16 --num-iters 4000
    python -m repro_torch.launch.schedd whatif  --port 5999 --model moe \\
                                                --num-gpus 32 \\
                                                --num-iters 2000 \\
                                                --strategies sr,ecmp
    python -m repro_torch.launch.schedd replay  --trace trace.csv \\
                                                --strategy sr --verify

``serve`` runs the daemon (crash-resume: point ``--event-log`` at an
existing log and it replays to the pre-crash state before listening).
``submit`` / ``whatif`` are thin protocol clients.  ``replay`` feeds a
recorded CSV trace through the service event loop *offline*; with
``--verify`` it also runs the differential oracle against
``simulate()`` and fails loudly on any divergence (exit 1).  ``serve`` and
``replay`` resolve rates on ``--device`` (default ``cuda``: the segment-max
kernel, raising where there is no card; ``cpu``: its plain version).  An
unknown command exits 2.

Not to be confused with ``repro_torch.launch.serve`` — that CLI decodes
trained models for inference; this one schedules training jobs onto the
cluster.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import List, Optional

from .sweep import cluster_presets


def _fresh(jobs):
    out = [copy.copy(j) for j in jobs]
    for j in out:
        j.start_time = j.finish_time = j.remaining_iters = None
    return out


def _parse_quotas(items: List[str]):
    quotas = {}
    for item in items:
        name, _, cap = item.partition("=")
        if not name or not cap.isdigit():
            raise argparse.ArgumentTypeError(
                f"quota {item!r} is not TENANT=GPUS")
        quotas[name] = int(cap)
    return quotas


def _add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where rate resolution runs: cuda (default; the "
                         "segment-max kernel, raises without a card) or "
                         "cpu (its plain version); schedules are identical")


def _add_job_args(ap: argparse.ArgumentParser) -> None:
    from ..core import PROFILES
    ap.add_argument("--model", required=True, choices=sorted(PROFILES))
    ap.add_argument("--num-gpus", type=int, required=True)
    ap.add_argument("--num-iters", type=int, required=True)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--allreduce-algo", default="ring")


def serve_main(argv) -> None:
    from ..core import SimConfig, strategy_names
    from ..core.scheduler import QUEUE_POLICIES
    from ..device import resolve_device
    from ..service import LiveCluster, SchedulerService, run_server
    clusters = cluster_presets()
    ap = argparse.ArgumentParser(prog="schedd serve")
    ap.add_argument("--cluster", default="512", choices=sorted(clusters))
    ap.add_argument("--ocs", action="store_true",
                    help="use the OCS-equipped preset variant")
    ap.add_argument("--strategy", default="sr", choices=strategy_names())
    ap.add_argument("--scheduler", default="fifo", choices=QUEUE_POLICIES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed on startup)")
    ap.add_argument("--event-log", default=None, metavar="PATH",
                    help="durable event log; an existing log is replayed "
                         "(crash resume) before the daemon listens")
    ap.add_argument("--no-fsync", action="store_true",
                    help="flush-only event log (survives process crash, "
                         "not power loss)")
    ap.add_argument("--quota", action="append", default=[],
                    metavar="TENANT=GPUS", help="per-tenant GPU cap "
                    "(repeatable)")
    _add_device_arg(ap)
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    spec, ocs_spec = clusters[args.cluster]
    if args.ocs:
        if ocs_spec is None:
            ap.error(f"cluster {args.cluster!r} has no OCS variant")
        spec = ocs_spec
    quotas = _parse_quotas(args.quota)
    cfg = SimConfig(strategy=args.strategy, scheduler=args.scheduler,
                    seed=args.seed, engine="v2")
    if args.event_log:
        live = LiveCluster.open(args.event_log, spec, cfg, quotas=quotas,
                                fsync=not args.no_fsync, device=device)
        print(f"[schedd] event log {args.event_log}: replayed "
              f"{live.ingested} records to t={live.now:g} "
              f"(version {live.version})", file=sys.stderr)
    else:
        live = LiveCluster(spec, cfg, quotas=quotas, device=device)
        print("[schedd] WARNING: no --event-log — state will not survive "
              "a restart", file=sys.stderr)

    def ready(port: int) -> None:
        print(f"[schedd] {args.strategy}/{args.scheduler} on "
              f"{spec.num_gpus} GPUs, listening on {args.host}:{port}",
              file=sys.stderr, flush=True)

    run_server(SchedulerService(live), args.host, args.port, ready=ready)


def submit_main(argv) -> None:
    from ..service import SchedClient
    ap = argparse.ArgumentParser(prog="schedd submit")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--tenant", default="default")
    ap.add_argument("--at", type=float, default=None, metavar="T",
                    help="virtual submission time (default: daemon's now)")
    _add_job_args(ap)
    args = ap.parse_args(argv)
    with SchedClient(args.host, args.port) as c:
        res = c.submit(args.model, args.num_gpus, args.num_iters,
                       batch_size=args.batch_size, tenant=args.tenant,
                       t=args.at, allreduce_algo=args.allreduce_algo)
    print(json.dumps(res, indent=1, sort_keys=True))


def whatif_main(argv) -> None:
    from .sweep import csv_arg
    from ..service import SchedClient
    ap = argparse.ArgumentParser(prog="schedd whatif")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--strategies", type=csv_arg(str), default=None,
                    help="comma-separated candidate strategies "
                         "(default: the daemon's live strategy)")
    ap.add_argument("--horizon", type=float, default=None)
    _add_job_args(ap)
    args = ap.parse_args(argv)
    with SchedClient(args.host, args.port) as c:
        res = c.whatif(args.model, args.num_gpus, args.num_iters,
                       batch_size=args.batch_size,
                       strategies=args.strategies, horizon=args.horizon)
    print(json.dumps(res, indent=1, sort_keys=True))


def replay_main(argv) -> None:
    from ..core import SimConfig, load_trace_csv, strategy_names
    from ..core.scheduler import QUEUE_POLICIES
    from ..device import resolve_device
    from ..service import LiveCluster, RecordingSimulator, replay_trace
    clusters = cluster_presets()
    ap = argparse.ArgumentParser(prog="schedd replay")
    ap.add_argument("--trace", required=True, metavar="CSV",
                    help="recorded job trace (repro_torch.core.workloads "
                         "CSV)")
    ap.add_argument("--cluster", default="512", choices=sorted(clusters))
    ap.add_argument("--strategy", default="sr", choices=strategy_names())
    ap.add_argument("--scheduler", default="fifo", choices=QUEUE_POLICIES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--event-log", default=None, metavar="PATH",
                    help="also record the replayed stream to a durable "
                         "service event log")
    ap.add_argument("--verify", action="store_true",
                    help="differential oracle: assert the service loop "
                         "matches offline simulate() bit-for-bit")
    _add_device_arg(ap)
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    spec, _ = clusters[args.cluster]
    trace = load_trace_csv(args.trace)
    cfg = SimConfig(strategy=args.strategy, scheduler=args.scheduler,
                    seed=args.seed, engine="v2")
    if args.event_log:
        live = LiveCluster.open(args.event_log, spec, cfg, device=device)
    else:
        live = LiveCluster(spec, cfg, device=device)
    rep = replay_trace(live, _fresh(trace))
    print(f"replay: {len(trace)} jobs through the service loop — "
          f"JCT {rep.avg_jct:.1f}s JWT {rep.avg_jwt:.1f}s "
          f"(n_finished={rep.n_finished})")
    if args.verify:
        off = RecordingSimulator(spec, config=cfg, device=device)
        rep_off = off.run(_fresh(trace))
        rep_ok = rep.to_journal() == rep_off.to_journal()
        pl_ok = live.sim.placements == off.placements
        if not (rep_ok and pl_ok):
            print("replay VERIFY FAILED: service loop diverged from "
                  f"simulate() (report identical: {rep_ok}, placements "
                  f"identical: {pl_ok})", file=sys.stderr)
            sys.exit(1)
        print(f"verify: OK — placements and metrics bit-identical to "
              f"offline simulate() ({len(off.placements)} placements)")
    live.close()


COMMANDS = {"serve": serve_main, "submit": submit_main,
            "whatif": whatif_main, "replay": replay_main}


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") \
            or argv[0] not in COMMANDS:
        print(__doc__)
        if argv and argv[0] not in ("-h", "--help"):
            print(f"unknown command {argv[0]!r}; "
                  f"choose from {sorted(COMMANDS)}", file=sys.stderr)
            sys.exit(2)
        return
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
