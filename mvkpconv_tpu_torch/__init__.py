"""mvkpconv_tpu_torch — the PyTorch / CUDA port of ``mvkpconv_tpu``.

The JAX package beside it is the reference: this package mirrors its layout
(``ops/``, ``models/``, ``training/config.py``, ``data/``) and keeps its
public layouts (channel-last batch dicts, the ``Pyramid`` fields, the shadow
index convention), so each module can be held against its counterpart.
Every kernel that the JAX package wrote in Pallas for the TPU is
hand-written CUDA C++ for Hopper (``csrc/``), each with a plain PyTorch
version beside it (``ops/kernels/``). The package imports torch and numpy,
never jax.
"""

__version__ = "0.1.0"
