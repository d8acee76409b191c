"""Shared conventions of the device op layer (``mvkpconv_tpu/ops/common.py``).

Padding convention ("shadow slot"): invalid / padded points live at
coordinate ``SHADOW_COORD`` so any distance computation excludes them, and
neighbor indices equal to ``num_support`` denote "no neighbor".
"""

from __future__ import annotations

import torch

# Large enough that a padded point is outside every query radius, small
# enough that its square (1e12) is exactly representable in float32.
SHADOW_COORD = 1.0e6


def masked_points(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Push invalid rows of (..., N, 3) points to SHADOW_COORD."""
    return torch.where(
        mask[..., None], points, torch.full_like(points, SHADOW_COORD)
    )


def check_tensor(name: str, t: torch.Tensor, dtype, ndim: int, device=None):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and rank
    ``ndim`` (and on ``device`` where given): what a kernel wrapper checks
    before it hands raw pointers to CUDA."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()} {tuple(t.shape)}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
