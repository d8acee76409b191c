"""The plain reference the benchmark holds the port's MVPNet to: PyTorch and
numpy only, importing nothing of ``jax``, ``mvkpconv_tpu`` or
``mvkpconv_tpu_torch``. ``model.py`` is the network (the 2D branch and the
lift reused from ``portbench/reference``, PointNet++ SSG written here),
``counting.py`` what a step needs at the published peaks.

The configuration ``mvpnet`` names this package as its ``reference``: it
provides the four functions of the contract in ``harness.py``'s docstring."""

from portbench.reference_mvpnet.counting import fps_seconds, peak_seconds
from portbench.reference_mvpnet.model import calibrate, logits, tensors

__all__ = ["calibrate", "fps_seconds", "logits", "peak_seconds", "tensors"]
