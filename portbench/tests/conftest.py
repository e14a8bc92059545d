"""Tests of the benchmark harness.

    python -m pytest portbench/tests -q -p no:cacheprovider

Tests that need a CUDA card carry the ``cuda`` marker and take the
``cuda_device`` fixture, which skips them where no card is found; on the
card: ``python -m pytest portbench/tests -q -m cuda``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control runs at the cell's own size "
                    "on the card only")
    return torch.device("cuda")
