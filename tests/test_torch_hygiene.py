"""The port stands alone and has no silent fallbacks.

* no module of ``src/repro_torch``, not ``chip_smoke.py`` and no
  ``examples/*_torch.py`` imports ``jax`` or anything of ``repro``;
* the port has no ``try`` at all (so none around a kernel launch that could
  fall back to the plain version) and calls no library attention or
  ``torch.compile``;
* entry points called without a device run on ``cuda`` and raise where no
  card is present, instead of running on the CPU;
* ``import repro_torch`` and every submodule import without a card, nvcc or
  triton.
"""

import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import phase_max as pm  # noqa: E402
from repro_torch.kernels import rwkv6  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import schedd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import kv_cache  # noqa: E402
from repro_torch.service import LiveCluster  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "examples").glob("*_torch.py"))
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}
FORBIDDEN_CALLS = ("scaled_dot_product_attention", "torch.compile",
                   "cudnn_attention", "flash_attn")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & FORBIDDEN_ROOTS, (path, roots & FORBIDDEN_ROOTS)


def test_package_has_no_try_and_no_library_attention():
    for path in sorted(PKG.rglob("*.py")):
        src = path.read_text()
        tries = [n.lineno for n in ast.walk(ast.parse(src))
                 if isinstance(n, ast.Try)]
        assert not tries, (path, tries)
        for name in FORBIDDEN_CALLS:
            assert name not in src, (path, name)


def test_every_module_imports_without_a_card():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")]
    for need in ("repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.phase_max", "repro_torch.kernels.rwkv6",
                 "repro_torch.models.ssm", "repro_torch.models.moe", "repro_torch.core.fairshare",
                 "repro_torch.core.simulator", "repro_torch.core.batched",
                 "repro_torch.core.strategies.builtin",
                 "repro_torch.core.rankmap", "repro_torch.data.pipeline",
                 "repro_torch.train.optimizer", "repro_torch.train.loop",
                 "repro_torch.train.checkpoint", "repro_torch.launch.train",
                 "repro_torch.launch.mesh", "repro_torch.core.traces",
                 "repro_torch.core.runtime", "repro_torch.core.campaign",
                 "repro_torch.testing", "repro_torch.testing.chaos",
                 "repro_torch.launch.sweep", "repro_torch.core.figures",
                 "repro_torch.launch.report", "repro_torch.service",
                 "repro_torch.service.state", "repro_torch.service.twin",
                 "repro_torch.service.server", "repro_torch.service.client",
                 "repro_torch.launch.schedd", "repro_torch.parallel",
                 "repro_torch.parallel.sharding",
                 "repro_torch.testing.gloo_cuda",
                 "repro_torch.testing.ranks", "repro_torch.launch.mesh",
                 "repro_torch.launch.dryrun", "repro_torch.models.context",
                 "repro_torch.models.moe", "repro_torch.bridge"):
        assert need in names
    for name in names:
        importlib.import_module(name)
    assert build.sources()["flash_attention"].name == "flash_attention.cu"
    assert build.sources()["phase_max"].name == "phase_max.cu"
    assert build.sources()["rwkv6"].name == "rwkv6.cu"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda cfg: transformer.init_lm(cfg),
    lambda cfg: transformer.LM.init(cfg),
    lambda cfg: serve.make_prompts(cfg, 1, 4),
    lambda cfg: kv_cache.init_decode_state(cfg, 1, 8),
    lambda cfg: bridge.params_from_numpy({"w": np.zeros(2, np.float32)}),
    lambda cfg: serve.main(["--reduced"]),
    lambda cfg: ltrain.main(["--reduced", "--steps", "1"]),
    lambda cfg: bridge.opt_state_from_numpy((np.zeros((), np.int32), {},
                                             {})),
    lambda cfg: core.mesh_device_order(
        core.IsolatedScheduler(core.CLUSTER512).submit(0, 8).placement,
        core.CLUSTER512),
], ids=["init_lm", "LM.init", "make_prompts", "init_decode_state",
        "params_from_numpy", "serve.main", "train.main",
        "opt_state_from_numpy", "mesh_device_order"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_card, entry):
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(cfg)


@pytest.mark.parametrize("entry", [
    lambda cfg: transformer.init_lm(cfg),
    lambda cfg: transformer.LM.init(cfg),
    lambda cfg: kv_cache.init_decode_state(cfg, 1, 8),
    lambda cfg: serve.main(["--arch", "rwkv6-3b", "--reduced"]),
    lambda cfg: ltrain.main(["--arch", "rwkv6-3b", "--reduced"]),
], ids=["init_lm", "LM.init", "init_decode_state", "serve.main",
        "train.main"])
def test_ssm_entry_points_default_to_cuda_and_raise(no_card, entry):
    cfg = configs.reduced(configs.get_config("rwkv6-3b"))
    before = rwkv6.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(cfg)
    assert rwkv6.launches == before


@pytest.mark.parametrize("entry", [
    lambda cfg: transformer.init_lm(cfg, dtype=torch.bfloat16),
    lambda cfg: transformer.LM.init(cfg, dtype=torch.bfloat16),
    lambda cfg: kv_cache.init_decode_state(cfg, 1, 8),
    lambda cfg: serve.main(["--arch", "deepseek-moe-16b", "--reduced",
                            "--param-dtype", "bfloat16"]),
], ids=["init_lm", "LM.init", "init_decode_state", "serve.main"])
def test_moe_entry_points_default_to_cuda_and_raise(no_card, entry):
    cfg = configs.reduced(configs.get_config("deepseek-moe-16b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(cfg)


@pytest.mark.parametrize("entry", [
    lambda cfg: transformer.init_lm(cfg),
    lambda cfg: transformer.LM.init(cfg),
    lambda cfg: kv_cache.init_decode_state(cfg, 1, 8),
    lambda cfg: serve.main(["--arch", "zamba2-2.7b", "--reduced"]),
], ids=["init_lm", "LM.init", "init_decode_state", "serve.main"])
def test_hybrid_entry_points_default_to_cuda_and_raise(no_card, entry):
    cfg = configs.reduced(configs.get_config("zamba2-2.7b"), num_layers=4)
    before = (fa.launches, rwkv6.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(cfg)
    assert (fa.launches, rwkv6.launches) == before


@pytest.mark.parametrize("entry", [
    lambda cfg: transformer.init_lm(cfg),
    lambda cfg: transformer.LM.init(cfg),
    lambda cfg: serve.main(["--arch", "phi-3-vision-4.2b", "--reduced"]),
], ids=["init_lm", "LM.init", "serve.main"])
def test_vlm_entry_points_default_to_cuda_and_raise(no_card, entry):
    cfg = configs.reduced(configs.get_config("phi-3-vision-4.2b"))
    before = fa.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(cfg)
    assert fa.launches == before


_VALS, _PTR = np.arange(3, dtype=np.int64), np.asarray([0, 1, 3])
_ALIBABA = str(PKG / "data" / "alibaba_sample.csv")
# an event log that must not be created without a card
_UNOPENED = str(ROOT / "reports" / "torch" / "never-created.log")


@pytest.mark.parametrize("entry", [
    lambda: core.simulate(core.CLUSTER512, [], "ecmp"),
    lambda: core.ClusterSimulator(core.CLUSTER512, strategy="best"),
    lambda: core.run_lanes(core.CLUSTER512, []),
    lambda: core.phase_worst_loads(_VALS, _PTR),
    lambda: core.maxmin_fair_torch([["a"], ["a", "b"]]),
    lambda: core.maxmin_fair([["a"]], backend="torch"),
    lambda: core.run_campaign(core.CLUSTER512,
                              core.CampaignGrid(strategies=("ecmp",)),
                              workload=core.WorkloadSpec(num_jobs=3,
                                                         max_gpus=8)),
    lambda: core.run_windowed_campaign(
        core.CLUSTER512, core.CampaignGrid(strategies=("ecmp",)), _ALIBABA,
        window_jobs=5),
    lambda: sweep.campaign_main(["--jobs", "3", "--max-gpus", "8",
                                 "--strategies", "ecmp"]),
    lambda: sweep.campaign_main(["--trace", _ALIBABA, "--window", "5",
                                 "--strategies", "ecmp", "--workers", "2"]),
    lambda: core.build_figure("hetero-interleave"),
    lambda: core.build_figure("real-trace"),
    lambda: core.build_all(),
    lambda: report.generate(progress=lambda _: None),
    lambda: report.main([]),
    lambda: report.main(["--check"]),
    lambda: LiveCluster(core.CLUSTER512, core.SimConfig(strategy="sr")),
    lambda: LiveCluster.open(_UNOPENED, core.CLUSTER512,
                             core.SimConfig(strategy="sr")),
    lambda: schedd.replay_main(["--trace", _ALIBABA]),
    lambda: schedd.serve_main(["--port", "0"]),
], ids=["simulate", "ClusterSimulator", "run_lanes", "phase_worst_loads",
        "maxmin_fair_torch", "maxmin_fair[torch]", "run_campaign",
        "run_windowed_campaign", "campaign_main", "campaign_main[windowed]",
        "build_figure", "build_figure[windowed]", "build_all",
        "report.generate", "report.main", "report.main[check]",
        "LiveCluster", "LiveCluster.open", "schedd.replay_main",
        "schedd.serve_main"])
def test_simulator_entry_points_default_to_cuda_and_raise(no_card, entry):
    before = pm.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    assert pm.launches == before
    assert not Path(_UNOPENED).exists()


def test_simulator_runs_on_cpu_only_when_asked():
    jobs = core.generate_trace(core.WorkloadSpec(num_jobs=5, max_gpus=8))
    rep = core.simulate(core.CLUSTER512, jobs, "ecmp", device="cpu")
    assert rep.n_finished == 5


def test_dispatch_has_no_path_for_other_devices():
    t = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no path"):
        ops.attention(t, t, t)
    with pytest.raises(ValueError, match="no path"):
        ops.rwkv6_mix(t, t, t, t, chunk=8)
