"""The benchmark's tests: CPU tests at the tiny sizes of `tiny`, and tests
marked ``card`` that run only where a CUDA card is (deciding in the
``card`` fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "python3 -m pytest port_bench/tests -m card")
    return torch.device("cuda")
