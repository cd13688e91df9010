"""mmbench's tests run from the root of a checkout: `python -m pytest
mmbench/tests -q`. The tests marked `cuda` need the card and skip here."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none (decided here,
    at run time, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
