"""Tests of the port's benchmark (``portbench/``), run with ``python -m pytest portbench/tests``.

They run on the CPU at tiny sizes; a test marked ``card`` needs an NVIDIA card and skips without
one (``python -m pytest portbench/tests -m card`` on the card)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
