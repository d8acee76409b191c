"""Wrappers of the hand-written CUDA kernels, each with its plain version.

Each kernel is a ``torch.library`` operator ``mvkpconv::<name>``: its CPU
kernel is the plain PyTorch version, its CUDA kernel launches the
hand-written kernel through ``ops/_build.py:launch`` (which counts the
launches: ``tracing.launch_counts``), and its fake kernel gives the
output's shape. A wrapper takes tensors all on the CPU or all on a CUDA
device (``ops/common.py:check_devices``) and never falls back from one to
the other.
"""
