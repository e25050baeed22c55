"""The paper's workflow through the port: the IsolatedScheduler grants a
contention-free placement, its leaf-contiguous rank order becomes the
device order, and the training stack runs on it.  The twins of
``tests/test_system.py::test_training_on_granted_placement`` and
``::test_mesh_device_order_matches_grant``, plus the training launcher on
the CPU and the port's rank map against the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CLUSTER512 as JCLUSTER512  # noqa: E402
from repro.core import CLUSTER512_OCS as JCLUSTER512_OCS  # noqa: E402
from repro.core import IsolatedScheduler as JScheduler  # noqa: E402
from repro.core import rankmap as jrankmap  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import (CLUSTER512, IsolatedScheduler,  # noqa: E402
                              leaf_contiguous_order, mesh_device_order)
from repro_torch.core.rankmap import (dp_axis_ring_flows,  # noqa: E402
                                      ep_axis_alltoall_flows,
                                      verify_ring_leafwise)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import vclos_device_order  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_init)
from repro_torch.train.train_step import make_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the small-tensor training tests: the suite
    runs six workers on eight cores, and torch's default thread pool per
    worker oversubscribes the cores; its spinning threads made a 60-step
    test take 210 s there against 5 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_training_on_granted_placement():
    """Submit -> grant -> train a tiny model on the granted placement
    (one device; the grant drives the logical rank order)."""
    sched = IsolatedScheduler(CLUSTER512, strategy="vclos")
    g = sched.submit(0, 64)
    assert g is not None
    order = leaf_contiguous_order(g.placement, CLUSTER512)
    assert verify_ring_leafwise(order, CLUSTER512)
    cfg = tcfg.reduced(tcfg.get_config("tinyllama-1.1b"), num_layers=1,
                       d_model=32, vocab_size=64, d_ff=64)
    params = TT.init_lm(cfg, 0, device="cpu")
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(cfg, opt_cfg)
    toks = np.random.default_rng(0).integers(0, 64, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, _, _, metrics = step(params, adamw_init(params, opt_cfg), None, batch)
    assert np.isfinite(float(metrics["loss"]))
    sched.release(0)
    assert sched.utilization() == 0.0


def test_mesh_device_order_matches_grant():
    sched = IsolatedScheduler(CLUSTER512, strategy="vclos")
    g = sched.submit(0, 64)
    fake_devices = [f"dev{i}" for i in range(64)]
    order = mesh_device_order(g.placement, CLUSTER512, devices=fake_devices)
    assert sorted(order) == sorted(fake_devices)
    assert vclos_device_order(g, CLUSTER512, fake_devices) == order
    # leaf-contiguity: the rank walk crosses leaf boundaries minimally
    gpus = leaf_contiguous_order(g.placement, CLUSTER512)
    leafs = [CLUSTER512.leaf_of_gpu(x) for x in gpus]
    crossings = sum(1 for a, b in zip(leafs, leafs[1:]) if a != b)
    assert crossings == len(set(leafs)) - 1
    with pytest.raises(ValueError, match="need 64 devices"):
        mesh_device_order(g.placement, CLUSTER512, devices=fake_devices[:8])


def _scrambled(placement_cls, n, seed):
    """A GPU set in no leaf order, as a relaxed placement may give one."""
    gpus = np.random.default_rng(seed).choice(512, n, replace=False)
    return placement_cls(job_id=0, gpus=[int(x) for x in gpus], kind="best")


@pytest.mark.parametrize("strategy,n", [("vclos", 64), ("vclos", 96),
                                        ("ocs-vclos", 32), ("scrambled", 24)])
def test_rank_map_matches_reference(strategy, n):
    """The port's copy of ``core/rankmap.py`` orders, verifies and maps
    devices as the reference does, on the same grants (and on a scrambled
    GPU set, which the order repairs)."""
    from repro.core.placement import Placement as JPlacement
    from repro_torch.core.placement import Placement
    if strategy == "scrambled":
        g, jg = _scrambled(Placement, n, 3), _scrambled(JPlacement, n, 3)
        spec, jspec = CLUSTER512, JCLUSTER512
    else:
        spec, jspec = ((core.CLUSTER512_OCS, JCLUSTER512_OCS)
                       if strategy == "ocs-vclos" else
                       (CLUSTER512, JCLUSTER512))
        sched, jsched = (IsolatedScheduler(spec, strategy=strategy),
                         JScheduler(jspec, strategy=strategy))
        for s in (sched, jsched):
            s.submit(100, 40)                    # fragment a bit
        g, jg = sched.submit(0, n).placement, jsched.submit(0, n).placement
    assert g.gpus == jg.gpus
    order = leaf_contiguous_order(g, spec)
    assert order == jrankmap.leaf_contiguous_order(jg, jspec)
    assert verify_ring_leafwise(order, spec) == \
        jrankmap.verify_ring_leafwise(order, jspec)
    devs = [f"d{i}" for i in range(n)]
    assert mesh_device_order(g, spec, devs) == \
        jrankmap.mesh_device_order(jg, jspec, devs)
    for mine, ref in ((dp_axis_ring_flows(order, spec),
                       jrankmap.dp_axis_ring_flows(order, jspec)),
                      (ep_axis_alltoall_flows(order, spec)[0],
                       jrankmap.ep_axis_alltoall_flows(order, jspec)[0])):
        assert [(f.src, f.dst) for f in mine] == [(f.src, f.dst)
                                                  for f in ref]


def test_core_exports_the_rank_map():
    assert core.leaf_contiguous_order is leaf_contiguous_order
    assert core.mesh_device_order is mesh_device_order


@pytest.mark.parametrize("argv", [
    ["--reduced", "--device", "cpu", "--steps", "3"],
    ["--reduced", "--device", "cpu", "--steps", "2", "--arch", "rwkv6-3b",
     "--batch", "2", "--seq", "32", "--remat", "full"],
    ["--reduced", "--device", "cpu", "--steps", "2", "--microbatches", "2",
     "--grad-compression", "--strategy", "ocs-vclos", "--batch", "4",
     "--seq", "32"],
], ids=["dense", "ssm-remat", "micro-compression-ocs"])
def test_train_main_runs_on_cpu(argv, capsys):
    before = fa.launches
    rep = ttrain.main(argv)
    steps = int(argv[argv.index("--steps") + 1])
    assert rep.steps_run == steps and len(rep.losses) == steps
    assert all(np.isfinite(rep.losses)) and all(np.isfinite(rep.grad_norms))
    out = capsys.readouterr().out
    assert "ring leaf-wise=True" in out and "done on cpu" in out
    assert fa.launches == before          # the CPU runs the plain versions


def test_train_main_with_a_checkpoint_dir_resumes(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "ck")]
    first = ttrain.main(argv + ["--steps", "50"])
    assert first.resumed_from is None and first.steps_run == 50
    again = ttrain.main(argv + ["--steps", "51"])
    assert again.resumed_from == 50 and again.steps_run == 51
    assert len(again.losses) == 1


def test_train_main_refuses_an_unplaceable_job():
    with pytest.raises(SystemExit, match="cannot place"):
        ttrain.main(["--reduced", "--device", "cpu", "--gpus", "4096"])


def test_train_module_runs_as_a_script_on_cpu():
    """``python -m repro_torch.launch.train --reduced --device cpu --steps
    3``, as the README gives it."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "OMP_NUM_THREADS": "1",     # see one_thread
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "3"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done on cpu: 3 steps" in out.stdout
