"""The readings the check's limits are set from, many seeds in one process:
the program's own (sound runs), the control's (the reference in fp8 put in
the program's place) and the planted faults'.

    python3 bench/readings.py --workload <cell> --mode <mode> --seeds a,b,c
        [--seconds s]

Modes: ``program``; ``control``; ``half_batch`` and ``unchanged`` (train
cells); ``altered_token`` (prefill cells).  A train cell's readings need
no window (its first steps are set-up's); a prefill cell's take a short one
of ``--seconds``.  One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import faults, harness  # noqa: E402
from bench.kinds import train  # noqa: E402


def reading(cell, seed: int, mode: str, seconds: float, device) -> dict:
    kind = cell.traffic["kind"]
    hooks = {}
    if mode in ("half_batch", "unchanged"):
        hooks["wrap_step"] = getattr(faults, mode)
    elif mode == "altered_token":
        hooks["wrap_prefill"] = faults.altered_token
    elif mode == "control" and kind == "prefill":
        hooks["wrap_prefill"] = faults.reference_prefill(cell.cfg, seed,
                                                         device, "fp8")
    run = cell.driver(seed, device, **hooks)
    if mode == "control" and kind == "train":
        got, ref = run.follow("fp8"), run.follow()
        numbers = {**train.compare(got, ref),
                   "worst": train.worst_units(got, ref)}
    else:
        run.setup()
        if kind != "train":
            run.window(seconds)
        run.release()
        torch.cuda.empty_cache()
        numbers = run.check()
        if kind == "train":
            numbers["worst"] = train.worst_units(run.readings, run.reference)
    del run
    torch.cuda.empty_cache()
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("program", "control", "half_batch", "unchanged",
                             "altered_token"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    harness.caches_in_checkout(ROOT)
    cell = harness.Cell(args.workload)
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = reading(cell, seed, args.mode, args.seconds, device)
        print(json.dumps({"workload": cell.name, "mode": args.mode,
                          "seed": seed, **numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
