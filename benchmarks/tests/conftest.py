"""CPU tests of the benchmark harness (``python -m pytest benchmarks/tests``).

Tests marked ``card`` need a CUDA device and skip without one; they
decide inside the test, never while this package is imported."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def tiny():
    """A traffic override that keeps a CPU run to a fraction of a second
    a frame."""
    return dict(width=12, height=12, spp=2, max_depth=3, lanes=4096)


@pytest.fixture(autouse=True)
def _one_thread_a_process(monkeypatch):
    # Four CPU ranks share the host's cores with the test workers.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
