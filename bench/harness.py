"""One run of one cell: ``python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

Everything about a cell is found by name under the benchmark's folder:
``BENCHMARK.json`` names the cell's configuration and traffic mix;
``configs/<config>.json`` holds the configuration as it is run and names
its reference (``reference/<name>.py``); ``traffic/<mix>.json`` holds the
mix's parameters and names the driver of its ``kind`` (``kinds/<kind>.py``);
``metrics/<metric>.py`` reads one per-layer metric from the traced run;
``limits/<cell>.json`` holds the limits of the numbers the check compares.

A run: set-up (imports, the kernels loaded from the build cache in the
checkout, weights made on the device from the seed, warm-up, the first
steps); the window of ``--seconds``; with ``--trace 1`` a traced segment
after it; the program's state freed; the check against the plain
reference.  The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(root: Path, folder: str, name: str) -> dict:
    return json.loads((root / "bench" / folder / f"{name}.json").read_text())


def load_metric(root: Path, name: str):
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic, the
    metrics it reports and the limits of its check."""

    def __init__(self, name: str, root: Path = ROOT, spec: dict = None):
        spec = load_spec(root) if spec is None else spec
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry, self.root = name, found[0], root
        self.cfg = load_json(root, "configs", self.entry["config"])
        self.traffic = load_json(root, "traffic", self.entry["traffic"])
        self.limits = load_json(root, "limits", name)

        def here(m):
            return m.get("workloads") is None or name in m["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if here(m)]
        self.per_layer = [m for m in spec["per_layer"] if here(m)]

    def driver(self, seed: int, device, **hooks):
        kind = importlib.import_module(f"bench.kinds.{self.traffic['kind']}")
        return kind.Run(self.cfg, self.traffic, seed, device, **hooks)


class View:
    """What a per-layer metric's reader sees of a run."""

    def __init__(self, cell: Cell, run, segment: dict, ranges, trace,
                 device_trace):
        self.cell, self.cfg, self.traffic = cell, cell.cfg, cell.traffic
        self.kind = cell.traffic["kind"]
        self.window = run.window_stats
        self.segment, self.trace, self._ranges = segment, trace, ranges
        self.device_trace = device_trace

    def calls(self, name: str):
        return self._ranges.calls.get(name, [])

    def device_seconds(self, name: str) -> float:
        n, found = len(self.calls(name)), self.trace.range_count(name)
        if n != found:
            raise RuntimeError(f"range {name}: {n} calls but {found} in the "
                               f"trace")
        seconds, kernels, lost = self.trace.range_time(name)
        print(f"bench: range {name}: {n} calls, "
              f"{self.trace.spans(name)} device spans, {kernels} kernels, "
              f"{lost} spans without their kernels, {seconds!r} s",
              file=sys.stderr, flush=True)
        return seconds


def caches_in_checkout(root: Path) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout (the
    program's own CUDA libraries already build into ``build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)


def log(t_start: float, what: str) -> None:
    print(f"bench: {time.perf_counter() - t_start:9.3f} s {what}",
          file=sys.stderr, flush=True)


def fifths(ends) -> list:
    """Steps or requests completed in each fifth of the window."""
    span = ends[-1] / 5
    return [sum(1 for t in ends if i * span < t <= (i + 1) * span)
            for i in range(5)]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, hooks: Optional[Dict[str, Callable]] = None
             ) -> dict:
    """One run; returns the result's fields (``metrics``, ``checked``,
    ``device`` and, traced, ``breakdown``)."""
    import torch
    from . import trace as tr
    run = cell.driver(seed, device, **(hooks or {}))
    log(t_start, f"set-up of {cell.name}, seed {seed}")
    run.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    # set-up's objects are kept out of the collector's scans, so that its
    # passes in the window cost what the window's own objects cost
    gc.collect()
    gc.freeze()
    log(t_start, "window")
    e2e = run.window(seconds)
    done = run.window_stats.get("steps", run.window_stats.get("requests"))
    log(t_start, f"window done: {done} in "
                 f"{run.window_stats['seconds']:.3f} s; by fifths "
                 f"{fifths(run.window_stats['ends'])}")
    out: Dict = {"device": {"count": cell.entry["chips"]}, "attempted": done}
    if device.type == "cuda":
        out["device"].update(
            platform="gpu", kind=torch.cuda.get_device_name(0),
            memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = {**e2e, "setup_s": setup_s}
        out["metrics"] = {n: {"value": values[n], "unit": units[n]}
                          for n in (m["name"] for m in cell.end_to_end)}
    else:
        readers = {m["name"]: load_metric(cell.root, m["name"])
                   for m in cell.per_layer}
        wanted = {}
        for r in readers.values():
            wanted.update(getattr(r, "RANGES", {}))
        # the device alone first (its idle share, its top operations),
        # then the host too, for the ranges' device time and the gaps' names
        with tr.profiled(host=False) as alone:
            segment = run.trace_segment()
        log(t_start, "device-only segment done")
        with tr.Ranges(wanted) as ranges, tr.profiled() as held:
            run.trace_segment()
        log(t_start, "traced segment done")
        view = View(cell, run, segment, ranges, held.trace, alone.trace)
        out["metrics"] = {}
        for name, reader in readers.items():
            value = reader.read(view)
            if value is not None:
                out["metrics"][name] = {"value": value, "unit": units[name]}
        out["device"].update(busy_s=alone.trace.busy_s,
                             window_s=alone.trace.window_s)
        out["breakdown"] = {"device_ops": alone.trace.device_ops(),
                            "idle_gaps": held.trace.idle_gaps()}
    gc.unfreeze()
    run.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(t_start, "check")
    numbers = run.check()
    log(t_start, "check done")
    for n, v in numbers.items():
        if n not in cell.limits:
            print(f"reading {n} {v!r} (not compared)", file=sys.stderr)
    out["checked"] = {n: {"value": v, "limit": cell.limits[n]}
                      for n, v in numbers.items() if n in cell.limits}
    out["correct"] = all(c["value"] <= c["limit"]
                         for c in out["checked"].values())
    return out


def forbidden_loaded() -> list:
    roots = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(roots & set(FORBIDDEN_MODULES))


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    caches_in_checkout(ROOT)
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.entry["chips"]:
        print(f"bench: {cell.name} needs {cell.entry['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"bench: the run loaded {bad}, which the benchmark may not",
              file=sys.stderr)
        return 4
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": 0,
              "metrics": out["metrics"], "device": out["device"]}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checked"] = out["checked"]
    for n, c in out["checked"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
