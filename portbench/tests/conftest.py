"""The benchmark's tests import ``portbench`` and the program from the
checkout's root; a test that needs the card asks for the ``cuda`` fixture,
which skips it where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    """One torch thread: the CPU tests' many small operations run no faster
    on more, and the test runner may hold several workers."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
