"""Runs one cell of the benchmark once; see ``bench/harness.py``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
