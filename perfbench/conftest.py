"""pytest settings of the benchmark's own tests (``pytest perfbench``).

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_device`` fixture, which skips them where there is none; whether
there is a card is decided inside the fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    from perfbench import harness

    return harness.load_benchmark(ROOT)
