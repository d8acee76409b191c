"""The plain reference the benchmark holds the port to: PyTorch and numpy
only, importing nothing of ``jax``, ``mvkpconv_tpu`` or
``mvkpconv_tpu_torch``. ``model.py`` is the network, ``geometry.py`` the
pyramid and the pixel association, ``unet.py`` the 2D network.

The MV-KPConv configurations name this package as their ``reference``: it
provides the four functions of the contract in ``harness.py``'s docstring,
from ``model.py`` and ``portbench/counting.py``."""

from portbench.reference.model import calibrate, logits, tensors

__all__ = ["calibrate", "logits", "peak_seconds", "tensors"]


def peak_seconds(model, batch, train, tf32) -> float:
    """The least time of one step at the published peaks, from the batch's
    pyramid (``counting.step_seconds_at_peak`` of ``counting.pyramid_stats``)."""
    from portbench import counting  # imported here: counting imports this package's modules

    return counting.step_seconds_at_peak(model, counting.pyramid_stats(batch, model), train, tf32)
