"""Rank groups on one host: spawn ``world`` processes, each in a process
group of the caller's backend, and join them with a deadline.

The rendezvous is a ``FileStore`` in a directory the caller names (no TCP
port, so concurrent groups never collide).  Each rank runs
``target(rank, world, *args)`` (a top-level function, since ranks are
spawned) and sends its return value back.  A rank that raises exits
non-zero with its traceback in its own stderr file; the first such rank,
or the deadline, ends the group: every rank still running is killed and
:class:`RankGroupError` carries the failing rank's traceback.  No rank's
failure is swallowed.
"""

from __future__ import annotations

import faulthandler
import multiprocessing as mp
import os
import queue
import sys
import time
import uuid
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, List, Sequence


class RankGroupError(RuntimeError):
    """A rank of the group failed, died, or the group missed its deadline."""


def _rank_main(rank: int, world: int, store: str, backend: str,
               target: Callable, args: Sequence, results, err_path: str,
               timeout: float) -> None:
    fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)                  # this rank's traceback goes to its file
    os.close(fd)
    faulthandler.enable()           # and its stack, should it crash
    import torch
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout))
    out = target(rank, world, *args)
    results.put((rank, out))
    dist.barrier()
    dist.destroy_process_group()
    sys.stderr.flush()


def _tail(path: Path, limit: int = 6000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-limit:]


def run_ranks(target: Callable, world: int, args: Sequence = (), *,
              workdir, timeout: float, backend: str = "gloo") -> List[Any]:
    """Every rank's return value, in rank order.  ``workdir`` holds the
    store and each rank's stderr (``rank<r>.err``)."""
    workdir = Path(workdir).resolve()   # the store's file:// URL
    workdir.mkdir(parents=True, exist_ok=True)
    tag = uuid.uuid4().hex[:8]
    store = str(workdir / f"store-{tag}")
    errs = [workdir / f"rank{r}-{tag}.err" for r in range(world)]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, store, backend, target, tuple(args),
                               results, str(errs[r]), timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    done: dict = {}
    failure = None
    while failure is None and (len(done) < world or any(
            p.exitcode is None for p in procs)):
        bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if bad:
            r = bad[0]
            failure = (f"rank {r} of {world} failed (exit code "
                       f"{procs[r].exitcode}):\n{_tail(errs[r])}")
        elif time.monotonic() > deadline:
            failure = (f"rank group of {world} missed its {timeout:.0f} s "
                       f"deadline; ranks done: {sorted(done)}\n" + "\n".join(
                           f"--- rank {r}:\n{_tail(e, 2000)}"
                           for r, e in enumerate(errs)))
        else:
            while True:
                item = _get(results)
                if item is None:
                    break
                done[item[0]] = item[1]
            if len(done) < world or any(p.exitcode is None for p in procs):
                time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    if failure is not None:
        raise RankGroupError(failure)
    return [done[r] for r in range(world)]


def _get(results):
    """The next (rank, value) sent, or None when none is waiting."""
    if results.empty():
        return None
    return results.get(timeout=5)


__all__ = ["RankGroupError", "run_ranks"]
