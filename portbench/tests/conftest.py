"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``chip`` that need a CUDA card and skip without one.

    python -m pytest portbench/tests -n 6          # here, on the CPU
    python -m pytest portbench/tests -m chip       # on the card
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
        "markers", "chip: needs a CUDA card; skips where torch sees none")


@pytest.fixture
def cuda():
    """The card, or a skip decided here, inside the test."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch sees none)")
    return "cuda:0"
