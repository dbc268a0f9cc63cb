"""pytest settings of the benchmark's own tests:

    python -m pytest portbench/tests -q -p no:cacheprovider

Tests marked ``cuda`` run a cell on a card and skip without one."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: runs on an NVIDIA card (skipped without)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
