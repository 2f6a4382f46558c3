"""pytest settings of the benchmark's own tests (``perfbench/tests``).

Registers the marker ``perfbench_chip`` for tests that need the CUDA
card; the ``chip`` fixture decides, when a test runs, whether there is
one and skips with the reason otherwise.  On the card:

    python3 -m pytest perfbench/tests -m perfbench_chip
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "perfbench_chip: needs a CUDA card; skipped without one")


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False "
                    "(run on the card: python3 -m pytest perfbench/tests "
                    "-m perfbench_chip)")
    return torch.device("cuda")
