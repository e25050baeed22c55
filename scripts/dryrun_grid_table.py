#!/usr/bin/env python
"""The dry-run grid as a markdown table: one row an arch, one column a
(shape, mesh), so that each cell of the grid is one cell of the table.

Reads the artifacts that ``python -m repro_torch.launch.sweep dryrun``
wrote (default ``artifacts/dryrun_torch/``; ``--tag l2`` for a cut grid)
and prints, for each cell, the roofline terms t_compute / t_memory /
t_collective in seconds and the dominant one, the temp memory a device in
GiB, the host seconds the cell took (set-up + counted runs) and how its
roofline was counted (full or scaled), or its status where it is not ok.
Then the grid's total host seconds and ``sweep.check_grid``'s problems.

  PYTHONPATH=src python scripts/dryrun_grid_table.py [--artifact-dir D] \\
      [--tag l2]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch import dryrun, sweep


def cell_text(r) -> str:
    if r is None:
        return "missing"
    if r.get("status") == "skipped":
        return "skipped"
    if r.get("status") != "ok":
        return f"{r.get('status')}: {str(r.get('error', ''))[:40]}"
    roof = r["roofline"]
    host = r.get("lower_s", 0) + r.get("compile_s", 0)
    return (f"{roof['t_compute']:.3g} / {roof['t_memory']:.3g} / "
            f"{roof['t_collective']:.3g} {roof['dominant'][:4]}, "
            f"{r['memory']['temp_size_in_bytes'] / 2**30:.3g} GiB, "
            f"{host:.1f} s {r.get('roofline_count', 'full')}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact-dir", default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = args.artifact_dir or dryrun.ARTIFACT_DIR
    cols = [(shape, mesh) for shape in sweep.SHAPE_ORDER
            for mesh in sweep.MESHES]
    print("| arch | " + " | ".join(
        f"{shape} {'multi-pod' if mesh == 'multipod' else mesh}"
        for shape, mesh in cols) + " |")
    print("|---" * (len(cols) + 1) + "|")
    total = 0.0
    for arch in sweep.ARCH_COST_ORDER:
        cells = [sweep._read_artifact(Path(dryrun.artifact_path(
            arch, shape, mesh, args.tag, root))) for shape, mesh in cols]
        total += sum(r.get("lower_s", 0) + r.get("compile_s", 0)
                     for r in cells if r)
        print(f"| {arch} | " + " | ".join(cell_text(r) for r in cells) +
              " |")
    print(f"\ngrid host seconds (set-up + counted runs): {total:.1f}")
    problems = sweep.check_grid(root, tag=args.tag)
    print(f"check_grid: {len(problems)} problems" +
          "".join(f"\n  {p}" for p in problems))
    print(json.dumps({"total_host_s": total, "problems": problems}))


if __name__ == "__main__":
    main()
