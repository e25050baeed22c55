"""The traced part of a run: ranges the benchmark wraps around calls into
the program, the profiler's trace of the device, and what the per-layer
metrics read from it.

A range is a ``record_function`` around a named callable of the program,
put in place from the benchmark's own files for the traced segment only;
each call also records a summary of its arguments (shapes, dtypes, flags),
from which the metrics count the call's work.  A target that is gone
raises: a metric whose call has left the program fails the traced run
instead of reading 0.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

PREFIX = "bench."                 # the benchmark's own ranges
WINDOW = PREFIX + "window"
# device-timeline events that mark a wait, not work
SYNCS = ("Context Sync", "Stream Sync", "Event Sync")


def host_kind(name: str) -> str:
    """A host event's kind, by name: the benchmark's ranges, CUDA runtime
    and driver calls (the launches), and the rest (operators)."""
    if name.startswith(PREFIX):
        return "range"
    if name.startswith("cuda") or name.startswith("cu"):
        return "launch"
    return "op"


def summarize(x):
    """A call argument as the metrics read it: a tensor's shape, dtype and
    element size; a tree's element count; a plain value as it is; an
    autograd context's saved tensors and plain attributes."""
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
                "esize": x.element_size()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, dict):
        n = [0]

        def walk(t):
            for v in t.values():
                if isinstance(v, dict):
                    walk(v)
                elif isinstance(v, torch.Tensor):
                    n[0] += v.numel()
        walk(x)
        return {"numel": n[0]}
    return None


def summarize_ctx(ctx):
    """An autograd backward's context: its saved tensors and its plain
    attributes (the flags its forward kept)."""
    attrs = {k: v for k, v in getattr(ctx, "__dict__", {}).items()
             if v is None or isinstance(v, (bool, int, float, str))}
    return {"saved": [summarize(t) for t in ctx.saved_tensors], **attrs}


def _resolve(target: str):
    """'module:Attr.attr' -> (owner object, attribute name, current value,
    whether it is a staticmethod on a class)."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *parents, name = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    if not hasattr(owner, name):
        raise AttributeError(f"trace: the wrapped call {target} is gone")
    static = isinstance(owner, type) and isinstance(
        owner.__dict__.get(name), staticmethod)
    return owner, name, getattr(owner, name), static


class Ranges:
    """Context manager: each range name wraps its target for its life."""

    def __init__(self, ranges: Dict[str, str]):
        self.ranges = ranges
        self.calls: Dict[str, List] = defaultdict(list)
        self._undo: List = []

    def __enter__(self):
        for rname, target in self.ranges.items():
            owner, name, fn, static = _resolve(target)
            self._undo.append((owner, name, owner.__dict__[name]
                               if isinstance(owner, type) else fn))
            calls = self.calls[rname]
            backward = target.endswith(".backward")

            def wrapped(*args, _fn=fn, _r=rname, _calls=calls,
                        _bwd=backward, **kwargs):
                _calls.append([summarize_ctx(a) if _bwd and i == 0
                               else summarize(a) for i, a in enumerate(args)])
                with torch.profiler.record_function(_r):
                    return _fn(*args, **kwargs)
            setattr(owner, name, staticmethod(wrapped) if static else wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)
        self._undo.clear()
        return False


class Trace:
    """The device's activity in the traced window, read from the
    profiler's events."""

    def __init__(self, events, wall_s: float):
        self.wall_s = wall_s
        self.kernels: List[Tuple[int, int, str, int]] = []
        cpu: List[Tuple[int, int, str, int, int, str]] = []
        self.gpu_ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == cuda:
                if name.startswith(PREFIX):
                    self.gpu_ranges[name].append((start, end))
                elif not any(m in name for m in SYNCS):
                    self.kernels.append((start, end, name,
                                         e.correlation_id()))
            else:
                cpu.append((start, end, name, e.start_thread_id(),
                            e.correlation_id(), host_kind(name)))
        self.kernels.sort()
        self.cpu = sorted(cpu)
        win = [(s, t) for s, t, n, *_ in self.cpu if n == WINDOW]
        self.windowed = bool(win)
        if win:     # host events recorded: the window is the range's span
            self.t0, self.t1 = win[0]
            self.kernels = [k for k in self.kernels
                            if k[1] > self.t0 and k[0] < self.t1]
        else:       # the device alone: every kernel is the segment's
            self.t0 = min((k[0] for k in self.kernels), default=0)
            self.t1 = max((k[1] for k in self.kernels), default=0)
        self.busy = self._union()

    def _union(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, e, *_ in self.kernels:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    @property
    def window_s(self) -> float:
        """The segment's length: the window range's span where host events
        were recorded, else the host's clock around it."""
        return (self.t1 - self.t0) / 1e9 if self.windowed else self.wall_s

    def range_count(self, name: str) -> int:
        return sum(1 for _, _, n, _, _, k in self.cpu
                   if n == name and k == "range")

    def spans(self, name: str) -> int:
        """The device-side spans the profiler drew for range ``name``."""
        return len(self.gpu_ranges.get(name, ()))

    def _by_span(self, name: str) -> List[List]:
        """The kernels in each device-side span the profiler drew for range
        ``name``, by their midpoint (so that a span whose ends are rounded
        keeps its kernels)."""
        spans = sorted(self.gpu_ranges.get(name, ()))
        starts = [s for s, _ in spans]
        out: List[List] = [[] for _ in spans]
        for k in self.kernels:
            mid = (k[0] + k[1]) // 2
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and mid <= spans[j][1]:
                out[j].append(k)
        return out

    def range_time(self, name: str) -> Tuple[float, int, int]:
        """(device seconds, kernels, spans whose kernels the trace lost) of
        range ``name``: the kernels in the device-side spans the profiler
        draws for the range, where it has them; else the kernels whose
        launch (matched by correlation id) lies inside the range on the
        host, on its thread.  A span whose kernels the trace lost (the
        profiler drew the span from them, but their records are missing)
        counts its own length, its first kernel's start to its last one's
        end."""
        if self.gpu_ranges.get(name):
            spans = sorted(self.gpu_ranges[name])
            total = kernels = lost = 0
            for (a, b), ks in zip(spans, self._by_span(name)):
                kernels += len(ks)
                lost += not ks
                total += sum(e - s for s, e, *_ in ks) if ks else b - a
            return total / 1e9, kernels, lost
        inside = [(s, e, t) for s, e, n, t, _, k in self.cpu
                  if n == name and k == "range"]
        launches = {c: (s, t) for s, _, _, t, c, k in self.cpu
                    if k == "launch"}
        ks = [k for k in self.kernels
              if (at := launches.get(k[3])) and any(
                  a <= at[0] <= b and th == at[1] for a, b, th in inside)]
        return sum(e - s for s, e, *_ in ks) / 1e9, len(ks), 0

    def device_seconds(self, name: str) -> float:
        """Device time of every kernel launched under range ``name``."""
        return self.range_time(name)[0]

    def device_ops(self, top: int = 10) -> List:
        """The device operations that took most time, [name, seconds]."""
        by_name: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.kernels:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[n, t / 1e9] for n, t in ops]

    def idle_gaps(self, top: int = 10) -> List:
        """The longest idle gaps of the device, [the innermost host event
        running at the gap's start, seconds]."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        return [[self.host_at(at), length / 1e9] for length, at in gaps]

    def host_at(self, t: int, reach: int = 20000) -> str:
        """The latest-started host event still running at ``t``: the
        innermost one."""
        i = bisect.bisect_right(self.cpu, (t, float("inf")))
        for s, e, n, _, _, k in reversed(self.cpu[max(0, i - reach):i]):
            if e >= t and k != "launch" and n != WINDOW:
                return n
        return "python"


@contextlib.contextmanager
def profiled(host: bool = True):
    """Profiles the block; yields a holder whose ``trace`` is set when the
    block ends.  ``host``: record the host's events too (operators, the
    benchmark's ranges), which the ranges' device time needs; without them
    only the device's activity is recorded, which adds least host time to
    what is measured (the idle share).  The card's activity is recorded
    where there is one."""
    from torch.profiler import ProfilerActivity, profile
    holder = type("Holder", (), {"trace": None})()
    cuda = torch.cuda.is_available()
    activities = (([ProfilerActivity.CPU] if host or not cuda else [])
                  + ([ProfilerActivity.CUDA] if cuda else []))
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            yield holder
            if cuda:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    holder.trace = Trace(prof.profiler.kineto_results.events(), wall)
