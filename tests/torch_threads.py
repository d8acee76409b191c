"""The port's thread policy for its tests: every ``tests/test_torch_*.py``
takes :func:`two_threads` as an autouse fixture by importing it
(``from torch_threads import two_threads``).

The fast tier runs six workers on the host's cores, and with torch's default
of an intra-op thread a core in every worker the CPU-heavy steps slow down
several-fold: on an 8-core host the CLI's early-fusion case took 150 s with
the default threads and 65 s with two (14 and 16 s alone), and the whole
tier (``-n 6``) 1,236 s with the default threads in all but two port files
and 484 s with two threads in every one. JAX's own threads, in the parity
tests' JAX half, are set by ``tests/conftest.py``, not here.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for the test, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
