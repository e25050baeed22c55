"""Runs of every cell at a tiny size on the CPU (the harness's look for a
chip skipped, the rest of a run driven), with the timed path broken
underneath: each fault a cell can have comes out not correct, and so does
the control, the reference computed with fp8 operands in the program's
place; sound runs come out correct.  The copy's limits are set for its
size (``bench/tests/tiny.py``); the cells' own were read on the card the
same way."""

import time

import pytest
import torch

from bench import faults, harness
from bench.kinds import train
from bench.tests.tiny import make_root

CPU = torch.device("cpu")
TRAIN = ["phi3v.train.4x2048", "rwkv6.train.4x2048"]
PREFILL = ["phi3v.prefill.256-4096"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, name, seed=2**33 + 5, **hooks):
    cell = harness.Cell(name, root=root)
    return harness.run_cell(cell, seed, 0.3, False, CPU, time.perf_counter(),
                            hooks)


@pytest.mark.parametrize("name", TRAIN + PREFILL)
def test_sound_runs_are_correct(root, name):
    out = run(root, name)
    assert out["correct"], out["checked"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_caught(root, name, fault):
    out = run(root, name, wrap_step=getattr(faults, fault))
    assert not out["correct"], out["checked"]


@pytest.mark.parametrize("name", PREFILL)
def test_an_altered_token_is_caught(root, name):
    out = run(root, name, wrap_prefill=faults.altered_token)
    assert not out["correct"], out["checked"]


@pytest.mark.parametrize("name", TRAIN)
def test_the_training_control_fails(root, name):
    cell = harness.Cell(name, root=root)
    r = cell.driver(2**33 + 5, CPU)
    numbers = train.compare(r.follow("fp8"), r.follow())
    assert any(numbers[n] > limit for n, limit in cell.limits.items()), \
        numbers


@pytest.mark.parametrize("name", PREFILL)
def test_the_serving_control_fails(root, name):
    cell = harness.Cell(name, root=root)
    seed = 2**33 + 5
    out = run(root, name, seed, wrap_prefill=faults.reference_prefill(
        cell.cfg, seed, CPU, "fp8"))
    assert not out["correct"], out["checked"]
