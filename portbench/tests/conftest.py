"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

They run on the CPU with the program's plain kernel versions at tiny sizes.
Tests marked ``card`` need a CUDA device and skip without one; whether
there is one is decided inside the ``card`` fixture, never at import."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the CPU steps are small and run beside other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
