"""The benchmark's CPU tests run their tiny models on two threads, so that
they take few of the cores the suite's other workers share."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
