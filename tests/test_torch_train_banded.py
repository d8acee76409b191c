"""PyTorch port: the train step in the ``banded`` and ``banded_bf16``
gather-VJP modes (K3's plain version here, the JAX package's Pallas kernel
in interpret mode) against the JAX package's ``make_train_step``, in f32
at the small configuration, and in bf16 ``compute_dtype``. The checks and
tolerances are those of ``test_torch_train_step.py``; the bf16 case holds
the loss of each of 3 steps within 2e-2 relative.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_train_step import batches, check_run, jax_run, port_run  # noqa: E402


@pytest.mark.parametrize("mode", ["banded", "banded_bf16"])
def test_train_step_small_matches_jax(mode):
    check_run("small", mode)


def test_train_step_bf16_loss_matches_jax():
    _, jmetrics, _ = jax_run("small", "banded_bf16", "bfloat16")["padded"]
    _, metrics, _ = port_run("small", "banded_bf16", batches("small")["padded"], "bfloat16")
    np.testing.assert_allclose([m[0] for m in metrics], [m[0] for m in jmetrics], rtol=2e-2)
