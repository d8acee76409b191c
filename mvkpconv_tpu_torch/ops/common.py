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


def check_devices(name: str, *tensors) -> None:
    """The kernel wrappers' device rule: every tensor (None skipped) on the
    CPU, where the operator runs its plain version, or every one on a CUDA
    device, where it runs its kernel; anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"{name}: unsupported devices {sorted(kinds)}")


def pairwise_sq_dists(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """(B, Nq, Ns) f32 squared distances of (B, Nq, 3) and (B, Ns, 3)
    points in the JAX package's expansion form ‖q‖² − 2 q·s + ‖s‖², clamped
    at 0 (``mvkpconv_tpu/ops/common.py:pairwise_sq_dists``).

    Plain f32 elementwise products and sums, each rounded once: no matmul
    (so no TF32 on the card) and no fused multiply-add, so the card and the
    CPU give the same bits. A query that coincides with a support gets 0
    exactly (its cross term rounds as its norm does). Elsewhere the
    expansion's error scales with ‖q‖², not d², so where a consumer divides
    by d² (``ops/interpolate.py``) its weights follow rounding, in the JAX
    package as here (``tests/test_torch_pn2.py`` holds both to a float64
    truth).
    """
    q = query.float()
    s = support.float()
    q2 = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]
    s2 = (s[..., 0] * s[..., 0] + s[..., 1] * s[..., 1]) + s[..., 2] * s[..., 2]
    a, b = q[:, :, None, :], s[:, None, :, :]
    cross = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]
    return ((q2[:, :, None] - 2.0 * cross) + s2[:, None, :]).clamp(min=0.0)


def difference_sq_dists(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """(B, Nq, Ns) f32 squared distances of (B, Nq, 3) and (B, Ns, 3)
    points in the difference form (dx² + dy²) + dz², each step rounded once,
    as the published PointNet++ CUDA ops (ball query, 3-NN), P1 and P2
    compute them: the error scales with d², not with ‖q‖², so a support on
    a ball's radius or a near key is placed as the published model places it wherever
    the cloud lies (the expansion form's error at room coordinates of 6 m is
    ~1e-5 m², a tenth of a percent of the first ball's r² = 0.01 m²). Plain
    elementwise products and sums: the card and the CPU give the same bits.
    Computed in place, two (B, Nq, Ns) blocks alive at most (the expansion
    form holds three), so not differentiable: positions that need no
    gradient only (PointNet++'s points and centroids)."""
    q = query.float()
    s = support.float()
    d2 = q[:, :, None, 0] - s[:, None, :, 0]
    d2.mul_(d2)
    for c in (1, 2):
        d = q[:, :, None, c] - s[:, None, :, c]
        d2.add_(d.mul_(d))
    return d2


def query_chunks(b: int, nq: int, ns: int, budget: int = 1 << 26):
    """Slices of the query axis that keep a (B, chunk, Ns) distance matrix
    within ``budget`` elements."""
    step = max(1, budget // max(b * ns, 1))
    return [slice(i, min(i + step, nq)) for i in range(0, nq, step)]
