"""Settings of the benchmark's own tests.

Run from the repository root: ``python -m pytest smcbench/tests -q``.
Tests marked ``chip`` need a CUDA card: the ``card`` fixture decides at
run time whether there is one and skips where there is none; on the card
they run with the same command.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The card, or a skip where the machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
    return torch.device("cuda")
