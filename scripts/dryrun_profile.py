#!/usr/bin/env python
"""Where one dry-run cell spends its host time.

Runs one cell of ``repro_torch.launch.dryrun`` (``lower_cell``, the
reference extrapolation off) in this process while a thread samples the
main thread's stack every 20 ms (the deepest other thread's where the main
thread waits for autograd's device thread, which runs the backward of cuda
tensors), and prints the cell's seconds and how it was counted, then the
share of samples by layer: the innermost frame of the stack that belongs to
one of

  recorder      launch/hlo_analysis.py (the counting dispatch mode)
  fake tensors  torch/_subclasses (fake-tensor dispatch, its cache keys)
  DTensor       torch/distributed/tensor (sharding propagation, redistribute
                planning, local dispatch)
  autograd      torch/autograd (the engine, Functions)
  port          src/repro_torch (model, train step, set-up)

and the ten innermost functions taking the most samples.  It imports
``repro_torch`` from ``PYTHONPATH``, so the same command profiles another
tree's port (an older commit unpacked beside this one).

  PYTHONPATH=src python scripts/dryrun_profile.py --arch tinyllama-1.1b \\
      --shape train_4k --mesh pod --device cuda [--count full|scaled]
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time

LAYERS = (("recorder", "launch/hlo_analysis.py"),
          ("fake tensors", "torch/_subclasses/"),
          ("DTensor", "torch/distributed/tensor/"),
          ("autograd", "torch/autograd/"),
          ("port", "repro_torch/"))


def layer_of(stack) -> str:
    for frame in reversed(stack):
        name = frame.f_code.co_filename
        for layer, part in LAYERS:
            if part in name:
                return layer
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--count", default="auto",
                    choices=["auto", "full", "scaled"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--opt-state-dtype", default=None)
    args = ap.parse_args()
    from repro_torch.launch import dryrun

    main_id = threading.get_ident()
    layers = collections.Counter()
    funcs = collections.Counter()
    done = threading.Event()

    def stack_of(frame):
        stack = []
        while frame is not None:
            stack.append(frame)
            frame = frame.f_back
        return stack[::-1]

    def sample():
        me = threading.get_ident()
        while not done.wait(0.02):
            frames = sys._current_frames()
            stack = stack_of(frames.get(main_id))
            if stack and stack[-1].f_code.co_name == "_engine_run_backward":
                # the backward of cuda tensors runs on autograd's device
                # thread while the main thread waits: sample that thread
                others = [stack_of(f) for t, f in frames.items()
                          if t not in (me, main_id)]
                stack = max(others, key=len, default=stack)
            if not stack:
                continue
            layers[layer_of(stack)] += 1
            top = stack[-1].f_code
            funcs[f"{top.co_filename.split('site-packages/')[-1]}:"
                  f"{top.co_name}"] += 1

    over = {"skip_aux": True, "count": args.count}
    if args.opt_state_dtype:
        over["opt_state_dtype"] = args.opt_state_dtype
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    r = dryrun.lower_cell(args.arch, args.shape, args.mesh == "multipod",
                          over, layers=args.layers, device=args.device)
    wall = time.perf_counter() - t0
    done.set()
    thread.join()
    total = sum(layers.values()) or 1
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
        "device": args.device, "status": r["status"],
        "error": r.get("error"), "wall_s": round(wall, 1),
        "lower_s": r.get("lower_s"), "run_s": r.get("compile_s"),
        "roofline_count": r.get("roofline_count", "full"),
        "microbatches": r.get("microbatches"), "ops": r.get("ops"),
        "reduced": r.get("reduced"),
        "t_compute": r.get("roofline", {}).get("t_compute"),
        "t_memory": r.get("roofline", {}).get("t_memory"),
        "t_collective": r.get("roofline", {}).get("t_collective"),
        "samples": total,
        "layers": {k: round(v / total, 4) for k, v in layers.most_common()},
        "top": [[k, round(v / total, 4)] for k, v in funcs.most_common(10)],
    }))


if __name__ == "__main__":
    main()
