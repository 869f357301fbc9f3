"""The benchmark's own tests: on the CPU at 16^3-24^3, and a few marked
``cuda`` that run the harness on a card and skip without one.

    python -m pytest fgbench/tests -q
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels")
    return torch.device("cuda")
