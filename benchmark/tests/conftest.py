"""CPU tests of the benchmark harness: ``python -m pytest benchmark/tests``
from the checkout's root.  Tests marked ``cuda`` need the card and skip
without one (decided inside the test)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
