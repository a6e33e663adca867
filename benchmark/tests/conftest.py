"""Test configuration of the benchmark's own tests.

Imports no JAX: the benchmark and everything it runs stay clear of the
JAX package. Tests that need a CUDA card are marked ``card`` and decide
inside the ``card`` fixture whether one is there.
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
        "markers",
        "card: needs a CUDA card; skips without one "
        "(`python -m pytest -m card benchmark/tests` on the card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
