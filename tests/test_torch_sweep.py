"""The dry-run grid of the port: ``sweep dryrun`` (``repro_torch.launch.
sweep``), its check of a grid's artifacts, and the production-mesh cells
whose faults the grid found.

* Cells on the 16 x 16 production mesh at full width, cut in depth and
  shape, that raised before: rwkv6-3b's train step (a "b" axis of 2 and
  data 16: the low-rank decay's weight grads reached DTensor split over
  the tokens), whisper-base's and qwen1.5-32b's (8 and 40 heads on a model
  axis of 16: the attention backward unflattened half a head, 2.5 heads),
  and zamba2-2.7b's train step, prefill and decode (40 SSM heads on 16: the
  causal conv split the whole-head columns again), and rwkv6-3b's decode
  step at a batch of one (long_500k's), whose low-rank decay is a partial
  sum over "data" (the card's PyTorch 2.11 could not add it to the
  FSDP-split ``decay_base``; ``tests/test_torch_gpu.py`` runs that cell
  there).  Each comes back ok.
* ``sweep dryrun`` on a two-cell sub-grid at ``--layers 1 --device cpu``
  writes both artifacts, skips them on a second run, reruns them with
  ``--force``, and writes an error artifact for a cell past ``--timeout``.
* The sweep's default sub-command is ``dryrun``.
* ``check_grid`` names a missing cell, a failed one, a roofline term that is
  not finite and a skip where ``cell_supported`` runs the cell.

Artifacts go under each test's ``tmp_path``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import sweep as TS  # noqa: E402


# ---------------------------------------------------------------------------
# the production mesh's faults
# ---------------------------------------------------------------------------

# (arch, mode, depth, rows): full width, 64 tokens a row, one microbatch;
# the last a decode step at a batch of one (long_500k's), which does not
# split over dp, at full depth (None), where FSDP splits ``decay_base``
PRODUCTION_CELLS = [("rwkv6-3b", "train", 1, 16),
                    ("whisper-base", "train", 1, 16),
                    ("qwen1.5-32b", "train", 1, 16),
                    ("zamba2-2.7b", "train", 6, 16),
                    ("zamba2-2.7b", "prefill", 6, 16),
                    ("zamba2-2.7b", "decode", 6, 16),
                    ("rwkv6-3b", "decode", None, 1)]


@pytest.mark.parametrize("arch,mode,layers,rows", PRODUCTION_CELLS,
                         ids=lambda x: str(x))
def test_production_mesh_cell_is_ok(arch, mode, layers, rows):
    r = TD.lower_cell(arch, "t", False,
                      {"skip_aux": True, "microbatches": 1},
                      shape_cfg=tcfg.ShapeConfig("t", 64, rows, mode),
                      layers=layers, device="cpu")
    assert r["status"] == "ok" and r["chips"] == 256
    assert r.get("reduced", {"num_layers": [0, None]})["num_layers"][1] == \
        layers
    assert r["roofline"]["t_collective"] > 0
    calls = r["kernel_op_calls"]
    if arch == "rwkv6-3b":          # remat full; decode in plain PyTorch
        assert calls == ({"rwkv6_fused_fwd": 2} if mode == "train" else {})
    if arch == "zamba2-2.7b":       # decode steps in plain PyTorch
        assert calls == {"train": {"rwkv6_fused_fwd": 12,
                                   "flash_attention_fwd": 1},
                         "prefill": {"rwkv6_fused_fwd": 6,
                                     "flash_attention_fwd": 1},
                         "decode": {}}[mode]


# ---------------------------------------------------------------------------
# sweep dryrun
# ---------------------------------------------------------------------------

SUB_GRID = ["--mesh", "pod", "--device", "cpu", "--layers", "1",
            "--archs", "tinyllama-1.1b", "--shapes", "decode_32k,long_500k"]


def _cells(out):
    return [line for line in out.splitlines() if line.startswith("[dryrun]")]


def test_sweep_writes_skips_and_forces(tmp_path, capsys):
    art = ["--artifact-dir", str(tmp_path)]
    TS.main(["dryrun"] + SUB_GRID + art)
    out = capsys.readouterr().out
    assert len(_cells(out)) == 2 and "2 of 2 cells ok or skipped" in out
    paths = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in paths] == [
        "tinyllama-1.1b--decode_32k--pod-l1.json",
        "tinyllama-1.1b--long_500k--pod-l1.json"]
    cell = json.loads(paths[0].read_text())
    assert cell["status"] == "ok" and cell["reduced"]["num_layers"][1] == 1
    assert json.loads(paths[1].read_text())["status"] == "skipped"
    assert TS.check_grid(tmp_path, ["pod"], ["tinyllama-1.1b"],
                         ["decode_32k", "long_500k"], "l1") == []
    stamp = [p.stat().st_mtime_ns for p in paths]
    TS.main(["dryrun"] + SUB_GRID + art)           # both done: skipped
    assert _cells(capsys.readouterr().out) == []
    assert [p.stat().st_mtime_ns for p in paths] == stamp
    TS.main(["dryrun"] + SUB_GRID + art + ["--force"])
    assert len(_cells(capsys.readouterr().out)) == 2
    assert all(p.stat().st_mtime_ns > s for p, s in zip(paths, stamp))


def test_sweep_timeout_writes_an_error_artifact(tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        TS.dryrun_main(["--mesh", "pod", "--device", "cpu", "--layers", "1",
                        "--archs", "tinyllama-1.1b", "--shapes",
                        "decode_32k", "--timeout", "1", "--artifact-dir",
                        str(tmp_path)])
    assert ei.value.code == 1
    out = capsys.readouterr().out
    assert "TIMEOUT" in out and "timeout>1s" in out
    cell = json.loads(
        (tmp_path / "tinyllama-1.1b--decode_32k--pod-l1.json").read_text())
    assert cell["status"] == "error" and cell["error"] == "timeout>1s"


def test_default_subcommand_is_dryrun(monkeypatch):
    seen = []
    monkeypatch.setattr(TS, "dryrun_main", seen.append)
    TS.main(["--mesh", "pod"])
    TS.main(["dryrun", "--force"])
    TS.main([])
    assert seen == [["--mesh", "pod"], ["--force"], []]


def test_sweep_order_matches_reference():
    from repro.launch import sweep as RS
    assert TS.ARCH_COST_ORDER == RS.ARCH_COST_ORDER
    assert TS.SHAPE_ORDER == RS.SHAPE_ORDER
    assert sorted(TS.ARCH_COST_ORDER) == sorted(tcfg.list_configs())


def test_unknown_arch_is_a_usage_error(tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        TS.dryrun_main(["--archs", "gpt-5", "--artifact-dir",
                        str(tmp_path)])
    assert ei.value.code == 2
    assert "gpt-5" in capsys.readouterr().err


@pytest.mark.parametrize("arch,layers,want", [
    ("zamba2-2.7b", 2, 6), ("zamba2-2.7b", 6, 6), ("zamba2-2.7b", 7, 12),
    ("zamba2-2.7b", 60, 54), ("tinyllama-1.1b", 2, 2),
    ("whisper-base", 9, 6), ("tinyllama-1.1b", None, None)])
def test_cell_layers_rounds_hybrids_up(arch, layers, want):
    assert TS.cell_layers(arch, layers) == want
    assert TS.cut_tag(layers) == (f"l{layers}" if layers else "")


# ---------------------------------------------------------------------------
# check_grid
# ---------------------------------------------------------------------------

def _write(root, arch, shape, mesh, record, tag=""):
    path = TD.artifact_path(arch, shape, mesh, tag, root)
    with open(path, "w") as f:
        json.dump({"arch": arch, "shape": shape, "mesh": mesh, **record}, f)


OK = {"status": "ok", "roofline": {"t_compute": 1e-3, "t_memory": 2e-3,
                                   "t_collective": 3e-3}}


def test_check_grid_names_every_problem(tmp_path):
    archs, shapes = ["tinyllama-1.1b", "rwkv6-3b"], ["decode_32k",
                                                    "long_500k"]
    _write(tmp_path, "tinyllama-1.1b", "decode_32k", "pod", OK)
    _write(tmp_path, "tinyllama-1.1b", "long_500k", "pod",
           {"status": "skipped", "reason": "full-attention arch"})
    _write(tmp_path, "rwkv6-3b", "decode_32k", "pod",
           {"status": "error", "error": "RuntimeError: boom"})
    assert TS.check_grid(tmp_path, ["pod"], archs, shapes) == [
        "rwkv6-3b decode_32k pod: error: RuntimeError: boom",
        "rwkv6-3b long_500k pod: missing"]
    _write(tmp_path, "rwkv6-3b", "decode_32k", "pod",
           {"status": "ok", "roofline": {**OK["roofline"],
                                         "t_memory": float("nan")}})
    _write(tmp_path, "rwkv6-3b", "long_500k", "pod",
           {"status": "skipped", "reason": "?"})
    assert TS.check_grid(tmp_path, ["pod"], archs, shapes) == [
        "rwkv6-3b decode_32k pod: roofline t_memory not finite",
        "rwkv6-3b long_500k pod: skipped, where cell_supported runs it"]
    _write(tmp_path, "rwkv6-3b", "decode_32k", "pod", OK)
    _write(tmp_path, "rwkv6-3b", "long_500k", "pod", OK)
    assert TS.check_grid(tmp_path, ["pod"], archs, shapes) == []
    # a cut grid is read under its own tag: the full-depth cells are not it
    assert len(TS.check_grid(tmp_path, ["pod"], archs, shapes, "l2")) == 4


def test_check_grid_reads_a_torn_artifact_as_missing(tmp_path):
    path = TD.artifact_path("tinyllama-1.1b", "decode_32k", "pod", "",
                            tmp_path)
    with open(path, "w") as f:
        f.write('{"status": "ok", "roofl')
    assert TS.check_grid(tmp_path, ["pod"], ["tinyllama-1.1b"],
                         ["decode_32k"]) == [
        "tinyllama-1.1b decode_32k pod: missing"]
