"""Wrappers of the hand-written CUDA kernels, each with its plain version.

A wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for tensors on a CUDA device (or raises); it never
falls back from one to the other. ``launches`` on each wrapper counts the
kernel launches.
"""
