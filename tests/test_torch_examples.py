"""The port's examples (``examples/*_torch.py``) against the reference's,
each run on the CPU in a subprocess as a user runs it.

* quickstart: steps 1-4 (admission, contention-freedom, ECMP collisions)
  print the reference script's lines exactly; step 5 trains from the
  port's own ``init_lm(seed=0)``, so its 5 losses are not the reference's:
  they are finite and fall;
* contention_analysis prints the reference's output exactly;
* multi_tenant_cluster ``--jobs 12``: its table equals the reference's,
  the wall-seconds column aside;
* train_lm ``--tiny --steps 2`` writes a checkpoint at step 2, and a second
  run on the same directory resumes from it.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(name, *argv, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                        *argv], env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_quickstart_matches_reference_steps_1_to_4():
    got = _run("quickstart_torch.py", "--device", "cpu").splitlines()
    want = _run("quickstart.py").splitlines()
    assert got[:5] == want[:5]
    assert got[0].startswith("granted 64 GPUs on leafs")
    assert got[1:4] == ["ring contention-free: True",
                        "halving-doubling contention-free: True",
                        "alltoall contention-free: True"]
    losses = [float(m) for m in re.findall(r"^step \d: loss (\S+)$",
                                           "\n".join(got), re.M)]
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert "attention kernel launches: 0 (2 layers x 5 steps on cpu)" in got
    assert got[-1] == want[-1]          # the release line


def test_contention_analysis_matches_reference():
    assert _run("contention_analysis_torch.py", "--device", "cpu") == \
        _run("contention_analysis.py")


def _table(text):
    """The strategy table's rows without the wall-seconds column."""
    return [re.sub(r" \[[0-9.]+s\]$", "", line)
            for line in text.splitlines()[:9]]


def test_multi_tenant_table_matches_reference():
    got = _run("multi_tenant_cluster_torch.py", "--jobs", "12", "--device",
               "cpu")
    want = _run("multi_tenant_cluster.py", "--jobs", "12")
    assert _table(got) == _table(want)
    assert len(want.splitlines()) == 9
    assert re.search(r"^segment-max kernel launches: 0 of \d+ solves on "
                     r"cpu$", got, re.M)


def test_train_lm_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _run("train_lm_torch.py", "--tiny", "--steps", "2",
                 "--ckpt-dir", ckpt, "--device", "cpu")
    assert "finished 2 steps" in first and "resumed_from=None" in first
    assert sorted(p.name for p in Path(ckpt).iterdir()) == ["step_00000002"]
    second = _run("train_lm_torch.py", "--tiny", "--steps", "4",
                  "--ckpt-dir", ckpt, "--device", "cpu")
    assert "[loop] resumed from step 2" in second
    assert "finished 4 steps" in second and "resumed_from=2" in second
    loss = re.search(r"loss (\S+) -> (\S+);", second)
    assert loss and np.isfinite([float(loss.group(1)),
                                 float(loss.group(2))]).all()
