"""Sweep commands of the port.

``campaign`` — trace-driven simulation campaign over a strategy × queueing
-policy × load × seed grid (paper §9, Tables 5-7), aggregated to JCT mean/
p99, queueing delay, makespan and contention-ratio CDFs, optionally written
to a JSON report.  Every cell's rate resolution runs on ``--device``
(default ``cuda``: the segment-max kernel; ``cpu``: its plain version).

  PYTHONPATH=src python -m repro_torch.launch.sweep campaign \\
      --cluster 512 --strategies best,sr,ecmp,vclos --schedulers fifo,ff \\
      --loads 200,120 --seeds 0,1,2 --jobs 500 --out campaign.json
  PYTHONPATH=src python -m repro_torch.launch.sweep campaign --trace jobs.csv \\
      --strategies ecmp,vclos --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sweep campaign --list-strategies

``dryrun`` (the default sub-command, as the reference's) — every (arch ×
shape × mesh) cell of the dry run (``launch/dryrun.py``) in its own
subprocess (crash isolation, bounded memory), cheap archs first, each
cell's last line printed with its seconds and the running total.  Cells
whose artifact already says ok or skipped are skipped unless ``--force``;
a cell past ``--timeout`` is written as an error artifact.  ``--device``
and ``--layers`` pass through to each cell (a hybrid cut rounds up to a
multiple of ``attn_every``; a cut cell's artifact is tagged ``l<N>``, so a
full-depth sweep never takes it for its own).  At the end
:func:`check_grid` reads the grid's artifacts back, and the sweep exits 1
if any cell is missing, failed or has a non-finite roofline term.

  PYTHONPATH=src python -m repro_torch.launch.sweep dryrun \
      [--mesh pod|multipod|both] [--device cpu] [--layers 2]

Strategies resolve against the plugin registry
(``repro_torch.core.strategies``) — ``--list-strategies`` prints every
registered plugin, and unknown names error out enumerating them.  Exit codes
follow the reference: a bad strategy, scheduler or size mix raises
``ValueError`` (exit 1); a bad trace, journal or flag is a usage error
(exit 2).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ARCH_COST_ORDER = [  # ascending estimated compile cost
    "whisper-base", "tinyllama-1.1b", "olmo-1b", "rwkv6-3b",
    "phi-3-vision-4.2b", "zamba2-2.7b", "deepseek-moe-16b",
    "qwen1.5-32b", "mixtral-8x22b", "nemotron-4-340b",
]
SHAPE_ORDER = ["decode_32k", "long_500k", "train_4k", "prefill_32k"]
MESHES = ("pod", "multipod")
SRC = Path(__file__).resolve().parents[2]


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------

def cell_layers(arch: str, layers: Optional[int]) -> Optional[int]:
    """The depth a ``--layers`` cut gives ``arch``: a hybrid's rounded up to
    a multiple of ``attn_every``, none deeper than the arch."""
    if not layers:
        return None
    from ..configs import get_config
    cfg = get_config(arch)
    k = cfg.attn_every or 1
    return min(math.ceil(layers / k) * k, cfg.num_layers)


def cut_tag(layers: Optional[int]) -> str:
    """The artifact tag of a depth cut (none at full depth)."""
    return f"l{layers}" if layers else ""


def _read_artifact(path: Path) -> Optional[Dict]:
    """A cell's artifact, or None where it is missing or torn."""
    from ..core.runtime import is_json
    if not path.exists():
        return None
    text = path.read_text()
    return json.loads(text) if is_json(text) else None


def check_grid(artifact_dir, meshes=MESHES, archs=None, shapes=None,
               tag: str = "") -> List[str]:
    """Every problem of a grid's artifacts, one line each: a cell that is
    missing, whose status is neither ok nor skipped, that is skipped where
    ``cell_supported`` runs it (or ok where it skips it), or whose
    roofline has a term that is not finite."""
    from ..configs import get_config
    from .dryrun import artifact_path, cell_supported
    out = []
    for mesh in meshes:
        for arch in archs or ARCH_COST_ORDER:
            for shape in shapes or SHAPE_ORDER:
                cell = f"{arch} {shape} {mesh}"
                r = _read_artifact(Path(artifact_path(arch, shape, mesh, tag,
                                                      artifact_dir)))
                if r is None:
                    out.append(f"{cell}: missing")
                    continue
                status = r.get("status")
                skip = cell_supported(get_config(arch), shape)
                if status not in ("ok", "skipped"):
                    out.append(f"{cell}: {status}: "
                               f"{str(r.get('error', ''))[:200]}")
                elif (status == "skipped") != bool(skip):
                    out.append(f"{cell}: {status}, where cell_supported "
                               f"{'skips' if skip else 'runs'} it")
                elif status == "ok":
                    roof = r.get("roofline", {})
                    bad = [k for k in ("t_compute", "t_memory",
                                       "t_collective")
                           if not math.isfinite(float(roof.get(k, "nan")))]
                    if bad:
                        out.append(f"{cell}: roofline {', '.join(bad)} not "
                                   f"finite")
    return out


def _run_with_timeout(cmd, env, timeout: float) -> Tuple[Optional[int], str]:
    """(exit code, or None past ``timeout`` seconds (the process killed);
    its stdout).  The output goes through a file, never a pipe that a
    chatty cell could fill."""
    with tempfile.TemporaryFile("w+") as out:
        proc = subprocess.Popen(cmd, env=env, stdout=out,
                                stderr=subprocess.DEVNULL, text=True)
        deadline = time.monotonic() + timeout
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.2)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            return None, ""
        out.seek(0)
        return proc.returncode, out.read()


def dryrun_main(argv) -> None:
    from .dryrun import artifact_path
    ap = argparse.ArgumentParser(
        prog="sweep dryrun",
        description="the dry run of every arch x shape x mesh cell, each in "
                    "its own subprocess")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--timeout", type=int, default=2400,
                    help="seconds a cell may take (default 2400)")
    ap.add_argument("--force", action="store_true",
                    help="rerun cells whose artifact says ok or skipped")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda: the H100 the "
                         "cells model; needs a CUDA build, not a card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each arch to this depth (a hybrid's rounded "
                         "up to a multiple of attn_every); artifacts tagged "
                         "l<N>")
    ap.add_argument("--archs", type=_csv(str), default=None,
                    help="a sub-grid's archs (default all, cheapest first)")
    ap.add_argument("--shapes", type=_csv(str), default=None,
                    help="a sub-grid's shapes (default all)")
    ap.add_argument("--artifact-dir", default=None,
                    help="default artifacts/dryrun_torch/")
    args = ap.parse_args(argv)
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    archs = [a for a in ARCH_COST_ORDER if a in (args.archs or
                                                 ARCH_COST_ORDER)]
    shapes = [s for s in SHAPE_ORDER if s in (args.shapes or SHAPE_ORDER)]
    unknown = set(args.archs or ()) - set(archs) | \
        set(args.shapes or ()) - set(shapes)
    if unknown:
        ap.error(f"unknown archs or shapes: {sorted(unknown)}")
    tag = cut_tag(args.layers)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    t00 = time.time()
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                path = Path(artifact_path(arch, shape, mesh, tag,
                                          args.artifact_dir))
                old = _read_artifact(path)
                if old and old.get("status") in ("ok", "skipped") and \
                        not args.force:
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--force", "--device", args.device]
                if args.layers:
                    cmd += ["--layers", str(cell_layers(arch, args.layers)),
                            "--tag", tag]
                if args.artifact_dir:
                    cmd += ["--artifact-dir", str(args.artifact_dir)]
                t0 = time.time()
                rc, out = _run_with_timeout(cmd, env, args.timeout)
                if rc is None:
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh,
                        "status": "error",
                        "error": f"timeout>{args.timeout}s"}))
                    print(f"[sweep] {arch} {shape} {mesh} TIMEOUT",
                          flush=True)
                    continue
                tail = out.strip().splitlines()
                print(tail[-1] if tail else f"(no output rc={rc})",
                      f"[{time.time() - t0:.0f}s, total "
                      f"{time.time() - t00:.0f}s]", flush=True)
    problems = check_grid(args.artifact_dir, meshes, archs, shapes, tag)
    print(f"[sweep] {len(meshes) * len(archs) * len(shapes) - len(problems)}"
          f" of {len(meshes) * len(archs) * len(shapes)} cells ok or "
          f"skipped", flush=True)
    for line in problems:
        print(f"[sweep]   {line}", flush=True)
    if problems:
        raise SystemExit(1)


def csv_arg(kind):
    """argparse ``type=`` factory for comma-separated lists."""
    def parse(s: str):
        return tuple(kind(v.strip()) for v in s.split(",") if v.strip())
    return parse


_csv = csv_arg   # historical alias


def cluster_presets():
    """Name → ``(spec, ocs_spec)`` map of the ``campaign`` CLI."""
    from ..core import (CLUSTER512, CLUSTER512_OCS, CLUSTER2048,
                        CLUSTER2048_OCS, TESTBED32)
    return {"512": (CLUSTER512, CLUSTER512_OCS),
            "2048": (CLUSTER2048, CLUSTER2048_OCS),
            "testbed": (TESTBED32, None)}


def _outcome(fn, *args, **kwargs):
    """``(result, None)`` or ``(None, exception)`` of one call, read from its
    future: how the CLI tells a bad trace or journal (a usage error, exit 2)
    from any other failure without catching it.  Used for reading the trace
    and opening the journal, never for running cells."""
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(fn, *args, **kwargs)
        exc = fut.exception()
    return (None, exc) if exc is not None else (fut.result(), None)


def _scan_windows(source, window, stride, max_windows) -> None:
    """Read exactly the jobs a windowed campaign will read, so that a
    malformed row it would meet mid-run is reported before the first
    window runs."""
    from ..core import iter_windows
    for _ in iter_windows(source.iter_jobs(), window, stride, max_windows):
        pass


def campaign_main(argv) -> None:
    from ..core import (ENGINES, CampaignGrid, JournalMismatch, SimConfig,
                        TraceFormatError, TraceSource, WorkloadSpec,
                        registered_strategies, run_windowed_campaign)
    from ..core.campaign import _execute, _prepare
    from ..core.workloads import is_float_literal
    from ..device import resolve_device

    clusters = cluster_presets()
    ap = argparse.ArgumentParser(
        prog="sweep campaign",
        description="strategy × policy × load × seed simulation campaign")
    ap.add_argument("--list-strategies", action="store_true",
                    help="print the registered strategy plugins "
                         "(name + description) and exit")
    ap.add_argument("--cluster", default="512", choices=sorted(clusters))
    ap.add_argument("--strategies", type=_csv(str),
                    default=("best", "vclos", "sr", "ecmp"))
    ap.add_argument("--schedulers", type=_csv(str), default=("fifo",))
    ap.add_argument("--loads", type=_csv(float), default=(120.0,),
                    help="mean inter-arrival gaps λ in seconds")
    ap.add_argument("--seeds", type=_csv(int), default=(0,))
    # workload-shape flags use None sentinels so combining them with
    # --trace (which fixes the workload) can be rejected instead of
    # silently ignored
    ap.add_argument("--jobs", type=int, default=None,
                    help="synthetic trace length (default 500)")
    ap.add_argument("--size-mix", default=None,
                    help="helios | tpuv4 | testbed (default helios)")
    ap.add_argument("--max-gpus", type=int, default=None,
                    help="cap job sizes (default: cluster size)")
    ap.add_argument("--deadline-slack", type=_csv(float), default=None,
                    metavar="LO,HI", help="assign deadlines for EDF runs")
    ap.add_argument("--events", default=None, metavar="K=V[,K=V...]",
                    help="dynamic-cluster churn for the synthetic workload "
                         "(repro_torch.core.events): keys preempt / resize "
                         "(fractions), server-mtbf / link-mtbf (seconds), "
                         "fail-duration, restart-iters — e.g. "
                         "--events preempt=0.1,server-mtbf=20000")
    ap.add_argument("--gpu-mix", default=None, metavar="NAME:SCALE:FRAC,...",
                    help="heterogeneous fleet: partition servers into GPU "
                         "generations with relative compute scales — e.g. "
                         "--gpu-mix h100:1.0:0.5,a100:0.62:0.5 (fractions "
                         "must sum to 1; a job runs at its slowest "
                         "member's scale — docs/heterogeneous.md)")
    ap.add_argument("--link-speeds", default=None, metavar="K=GBPS[,K=GBPS]",
                    help="per-tier fabric speeds: keys leaf (leaf↔spine "
                         "uplinks) / nic (server NICs), Gbps — e.g. "
                         "--link-speeds leaf=200,nic=100 "
                         "(docs/heterogeneous.md)")
    ap.add_argument("--defrag", type=float, default=0.0, metavar="SECONDS",
                    help="migration-defragmentation tick period (0 = off; "
                         "only strategies with supports_migration move "
                         "jobs, every strategy samples the frag index)")
    ap.add_argument("--trace", default=None,
                    help="CSV arrival trace to replay instead of a "
                         "synthetic workload (see repro_torch.core.workloads)")
    ap.add_argument("--trace-format", default="auto",
                    choices=("auto", "csv", "alibaba", "generic"),
                    help="trace schema adapter: auto sniffs the header; "
                         "csv = native schema, alibaba = PAI task "
                         "taxonomy, generic = Philly/Helios-style column "
                         "aliases (docs/traces.md)")
    ap.add_argument("--window", type=int, default=None, metavar="JOBS",
                    help="windowed replay: stream the trace as JOBS-job "
                         "windows, one seeds-axis slice per window "
                         "(bounded memory on million-job traces; "
                         "requires --trace)")
    ap.add_argument("--stride", type=int, default=None, metavar="JOBS",
                    help="spacing between window starts (default: "
                         "--window, i.e. non-overlapping windows)")
    ap.add_argument("--max-windows", type=int, default=None, metavar="N",
                    help="stop after N windows — the streaming reader "
                         "never scans past the windowed span")
    ap.add_argument("--full-recompute", action="store_true",
                    help="use the full-recompute rate engine (debug)")
    ap.add_argument("--engine", default="v2", choices=ENGINES,
                    help="simulator engine: v2 heap engine (default), the "
                         "v1 scan engine, or the batched lane engine "
                         "(serial campaigns advance qualifying cells in "
                         "lockstep; docs/batched.md) — bit-identical "
                         "schedules")
    ap.add_argument("--workers", type=int, default=None,
                    help="shard grid cells across N spawned processes "
                         "(deterministic merge; default: serial)")
    ap.add_argument("--stream", action="store_true",
                    help="streaming aggregation: bound per-cell memory to "
                         "O(512) samples (10k-job campaigns)")
    ap.add_argument("--ilp-time-limit", type=float, default=2.0)
    ap.add_argument("--cell-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="kill cells running longer than this (> 0; "
                         "forces pool execution so hung cells can be "
                         "terminated)")
    ap.add_argument("--max-retries", type=int, default=None, metavar="N",
                    help="extra attempts for crashed / timed-out / "
                         "transient cells (>= 0; default 2)")
    ap.add_argument("--quarantine", action="store_true",
                    help="record permanently-failing cells in "
                         "failed_cells and keep going instead of "
                         "aborting the campaign")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="append every completed cell to this JSONL "
                         "journal (crash-safe; resume with --resume)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="continue a journaled campaign: skip cells "
                         "already in PATH and append new completions — "
                         "the merged result is bit-identical to an "
                         "uninterrupted run (docs/robustness.md)")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--device", default="cuda",
                    help="where rate resolution runs: cuda (default; the "
                         "segment-max kernel, raises without a card) or "
                         "cpu (its plain version); reports are identical")
    args = ap.parse_args(argv)
    if args.list_strategies:
        for name, strat in registered_strategies().items():
            print(f"{name:22s} {strat.description}")
        return
    if args.deadline_slack is not None and len(args.deadline_slack) != 2:
        ap.error("--deadline-slack takes exactly two values: LO,HI "
                 f"(got {','.join(map(str, args.deadline_slack))})")
    if args.cell_timeout is not None and args.cell_timeout <= 0:
        ap.error(f"--cell-timeout must be > 0 seconds "
                 f"(got {args.cell_timeout:g}); omit it to disable "
                 f"per-cell timeouts")
    if args.max_retries is not None and args.max_retries < 0:
        ap.error(f"--max-retries must be >= 0 (got {args.max_retries}); "
                 f"0 means a single attempt per cell")
    if args.journal and args.resume and args.journal != args.resume:
        ap.error("pass either --journal PATH (start a fresh journal) or "
                 "--resume PATH (continue one), not both")
    if args.resume and not os.path.exists(args.resume):
        ap.error(f"--resume {args.resume!r} does not exist; use "
                 f"--journal {args.resume!r} to start a fresh journal")
    if args.journal and not args.resume and os.path.exists(args.journal):
        ap.error(f"--journal {args.journal!r} already exists; use "
                 f"--resume {args.journal!r} to continue it (or remove "
                 f"the file for a fresh run)")
    if args.trace:
        clash = [name for name, val in
                 (("--jobs", args.jobs), ("--size-mix", args.size_mix),
                  ("--max-gpus", args.max_gpus),
                  ("--deadline-slack", args.deadline_slack),
                  ("--events", args.events))
                 if val is not None]
        if clash:
            ap.error(f"--trace fixes the workload; {', '.join(clash)} "
                     "only shape synthetic traces and would be ignored")
    else:
        for flag, on in (("--trace-format", args.trace_format != "auto"),
                         ("--window", args.window is not None),
                         ("--stride", args.stride is not None),
                         ("--max-windows", args.max_windows is not None)):
            if on:
                ap.error(f"{flag} only applies to trace replay; pass "
                         f"--trace PATH")
    if args.window is None:
        if args.stride is not None or args.max_windows is not None:
            ap.error("--stride/--max-windows only apply to windowed "
                     "replay; pass --window JOBS")
    else:
        if args.window < 1:
            ap.error(f"--window must be >= 1 job (got {args.window})")
        if args.stride is not None and args.stride < 1:
            ap.error(f"--stride must be >= 1 job (got {args.stride})")
        if args.max_windows is not None and args.max_windows < 1:
            ap.error(f"--max-windows must be >= 1 (got {args.max_windows})")
        if len(args.seeds) != 1:
            ap.error("windowed replay repurposes the seeds axis as the "
                     "window index; pass a single --seeds entry")
        if args.journal or args.resume:
            ap.error("--journal/--resume do not support windowed replay; "
                     "run without --window to journal a trace campaign")

    churn = {}
    if args.events:
        keymap = {"preempt": "preempt_fraction",
                  "resize": "resize_fraction",
                  "server-mtbf": "server_mtbf", "link-mtbf": "link_mtbf",
                  "fail-duration": "fail_duration",
                  "restart-iters": "restart_iters"}
        for item in args.events.split(","):
            key, _, val = item.partition("=")
            key = key.strip()
            if key not in keymap or not val:
                ap.error(f"--events: bad entry {item!r}; use K=V with K in "
                         f"{sorted(keymap)}")
            if not is_float_literal(val):
                ap.error(f"--events: {key}={val!r} is not a number")
            fval = float(val)
            if fval < 0:
                ap.error(f"--events: {key}={val} must be >= 0 "
                         "(0 disables the knob)")
            churn[keymap[key]] = fval

    spec, ocs_spec = clusters[args.cluster]
    if args.link_speeds:
        import dataclasses

        from ..core.topology import link_speed_error
        keymap = {"leaf": "leaf_uplink_gbps", "nic": "server_nic_gbps"}
        speeds = {}
        for item in args.link_speeds.split(","):
            key, _, val = item.partition("=")
            key = key.strip()
            if key not in keymap or not val:
                ap.error(f"--link-speeds: bad entry {item!r}; use K=GBPS "
                         f"with K in {sorted(keymap)} — e.g. "
                         f"--link-speeds leaf=200,nic=100")
            if not is_float_literal(val):
                ap.error(f"--link-speeds: {key}={val!r} is not a number")
            speeds[keymap[key]] = float(val)
        # the spec's own check, in its field order
        for name in ("leaf_uplink_gbps", "server_nic_gbps"):
            why = link_speed_error(name, speeds.get(name), spec.link_gbps)
            if why is not None:
                ap.error(f"--link-speeds: {why}")
        spec = dataclasses.replace(spec, **speeds)
        if ocs_spec is not None:
            ocs_spec = dataclasses.replace(ocs_spec, **speeds)
    if args.gpu_mix:
        from ..core import apply_gpu_mix
        from ..core.topology import gpu_mix_error
        mix = []
        for item in args.gpu_mix.split(","):
            parts = item.split(":")
            if len(parts) != 3 or not parts[0].strip():
                ap.error(f"--gpu-mix: bad entry {item!r}; use "
                         f"NAME:SCALE:FRACTION — e.g. "
                         f"--gpu-mix h100:1.0:0.5,a100:0.62:0.5")
            if not (is_float_literal(parts[1])
                    and is_float_literal(parts[2])):
                ap.error(f"--gpu-mix: {item!r} has a non-numeric "
                         f"scale/fraction")
            mix.append((parts[0].strip(), float(parts[1]), float(parts[2])))
        for target in (spec, ocs_spec):
            why = (gpu_mix_error(target, mix) if target is not None
                   else None)
            if why is not None:
                ap.error(f"--gpu-mix: {why}")
        spec = apply_gpu_mix(spec, mix)
        if ocs_spec is not None:
            ocs_spec = apply_gpu_mix(ocs_spec, mix)
    grid = CampaignGrid(strategies=tuple(args.strategies),
                        schedulers=tuple(args.schedulers),
                        loads=tuple(args.loads), seeds=tuple(args.seeds))
    device = str(resolve_device(args.device))
    # TraceSource with format="csv" goes through the exact same row
    # validation as load_trace_csv, so native traces stay bit-identical
    source = (TraceSource(args.trace, format=args.trace_format)
              if args.trace else None)
    trace = None
    if source is not None and args.window is None:
        trace, exc = _outcome(source.load)
        if isinstance(exc, ValueError):    # covers TraceFormatError
            ap.error(str(exc))
        if exc is not None:
            raise exc
    workload = WorkloadSpec(
        num_jobs=500 if args.jobs is None else args.jobs,
        size_mix="helios" if args.size_mix is None else args.size_mix,
        max_gpus=spec.num_gpus if args.max_gpus is None else args.max_gpus,
        deadline_slack=tuple(args.deadline_slack) if args.deadline_slack
        else None, **churn)
    config = SimConfig(engine=args.engine,
                       trace_format=args.trace_format,
                       incremental=not args.full_recompute,
                       workers=args.workers,
                       store="stream" if args.stream else "full",
                       defrag_interval=args.defrag,
                       ilp_time_limit=args.ilp_time_limit,
                       cell_timeout=args.cell_timeout or 0.0,
                       max_retries=(2 if args.max_retries is None
                                    else args.max_retries),
                       quarantine=args.quarantine)

    def progress(m):
        print(m, flush=True)

    if args.window is not None:
        # a malformed trace surfacing mid-stream is a usage error too
        _, exc = _outcome(_scan_windows, source, args.window, args.stride,
                          args.max_windows)
        if isinstance(exc, TraceFormatError):
            ap.error(str(exc))
        if exc is not None:
            raise exc
        result = run_windowed_campaign(
            spec, grid, source, args.window, args.stride,
            args.max_windows, ocs_spec=ocs_spec, config=config,
            progress=progress, device=device)
    else:
        prepared, exc = _outcome(
            _prepare, spec, grid, workload=workload, trace=trace,
            incremental=None, engine=None, workers=None, store=None,
            ilp_time_limit=None, ocs_spec=ocs_spec, progress=progress,
            config=config, cell_timeout=None, max_retries=None,
            quarantine=None, journal=args.journal, resume=args.resume,
            device=device)
        if isinstance(exc, JournalMismatch):
            # surface journal/grid mismatches as CLI usage errors, like the
            # --events validation above
            ap.error(str(exc))
        if exc is not None:
            raise exc
        result = _execute(prepared)
    cols = ("strategy", "scheduler", "load", "n_finished", "jct_mean",
            "jct_p99", "queue_delay_mean", "makespan_mean",
            "contention_ratio_mean")
    if args.events or args.defrag:
        cols += ("preemptions", "failures", "resizes", "migrations",
                 "goodput_mean", "frag_index_mean")
    print(",".join(cols))
    for row in result.aggregate():
        # contention ratios (1.0-1.3) and frag indices (0-1) need three
        # decimals: one decimal erases the signal
        print(",".join(f"{row[c]:.3f}" if c in ("contention_ratio_mean",
                                                "frag_index_mean")
                       else f"{row[c]:.1f}" if isinstance(row[c], float)
                       else str(row[c]) for c in cols))
    if result.resumed_cells:
        print(f"[campaign] {result.resumed_cells} cell(s) loaded from "
              f"the journal", flush=True)
    if result.failed_cells:
        print(f"[campaign] WARNING: {len(result.failed_cells)} cell(s) "
              f"quarantined:", flush=True)
        for fc in result.failed_cells:
            print(f"  - {fc.strategy}/{fc.scheduler} λ={fc.load:g} "
                  f"seed={fc.seed}: {fc.kind} after {fc.attempts} "
                  f"attempt(s) — {fc.error}", flush=True)
    missing = result.missing_cells()
    if missing:
        print(f"[campaign] WARNING: table above pools only "
              f"{result.grid.size - len(missing)}/{result.grid.size} "
              f"cells", flush=True)
    if args.out:
        result.save(args.out)
        print(f"[campaign] report -> {args.out}", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("dryrun", "campaign"):
        cmd, argv = argv[0], argv[1:]
    else:
        cmd = "dryrun"   # the reference's default
    if cmd == "campaign":
        campaign_main(argv)
    else:
        dryrun_main(argv)


if __name__ == "__main__":
    main()
