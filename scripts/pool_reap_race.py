#!/usr/bin/env python3
"""Reproduce the race behind the reference's flaky
``tests/test_runtime.py::test_shutdown_pool_kills_hung_workers``.

Each trial does what that test does: two workers of a
``ProcessPoolExecutor`` sleep, ``repro.core.runtime._shutdown_pool(pool,
kill=True)`` terminates them, and each worker is joined and asked
``is_alive()``.  A failure is a worker that reads as alive although its
``/proc`` entry is already gone: the pool's manager thread reaped it with
a blocking ``waitpid`` and had not stored the return code yet, so the
test thread's own ``waitpid`` got ``ECHILD``, which ``Popen.poll`` reports
as still running.  ``--load N`` runs N busy processes beside the trials,
as a loaded test run does.

    PYTHONPATH=src python scripts/pool_reap_race.py --load 7 --trials 400
    PYTHONPATH=src python scripts/pool_reap_race.py --start spawn --load 7
"""

import argparse
import multiprocessing as mp
import os
import time
from concurrent.futures import ProcessPoolExecutor

from repro.core.runtime import _shutdown_pool


def _burn(stop) -> None:
    while not stop.is_set():
        sum(range(10000))


def trial(ctx):
    """One run of the test's logic; the workers it saw as alive."""
    pool = ProcessPoolExecutor(max_workers=2, mp_context=ctx)
    pool.submit(time.sleep, 300)
    pool.submit(time.sleep, 300)
    deadline = time.monotonic() + 30.0
    while len(pool._processes or {}) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    procs = list(pool._processes.values())
    _shutdown_pool(pool, kill=True)
    alive = []
    for p in procs:
        p.join(timeout=10.0)
        if p.is_alive():
            gone = not os.path.exists(f"/proc/{p.pid}")
            alive.append((p.pid, "reaped" if gone else "running"))
    time.sleep(0.05)
    return alive, [p.is_alive() for p in procs]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start", default="fork", choices=("fork", "spawn"))
    ap.add_argument("--load", type=int, default=0,
                    help="busy processes run beside the trials")
    ap.add_argument("--trials", type=int, default=100)
    args = ap.parse_args()
    ctx = mp.get_context(args.start)
    stop = mp.get_context("fork").Event()
    burners = [mp.get_context("fork").Process(target=_burn, args=(stop,))
               for _ in range(args.load)]
    for b in burners:
        b.start()
    failures = 0
    for i in range(args.trials):
        alive, later = trial(ctx)
        if alive:
            failures += 1
            print(f"trial {i}: read as alive after join {alive}; 50 ms "
                  f"later alive: {later}", flush=True)
    stop.set()
    for b in burners:
        b.join()
    print(f"start={args.start} load={args.load} trials={args.trials} "
          f"failures={failures}")


if __name__ == "__main__":
    main()
