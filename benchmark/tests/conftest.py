"""The benchmark's tests: on the CPU at small sizes, and (marked `card`)
on a CUDA device, where each skips itself without one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips itself without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
