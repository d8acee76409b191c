"""Point cloud augmentation (host-side numpy): a copy of
``mvkpconv_tpu/data/transforms.py`` (``tests/test_torch_data.py`` pins it).

Mirrors PointCloudDataset.augmentation_transform (KPConv-PyTorch/datasets/
common.py:252-329): random vertical (or full) rotation, anisotropic scale
with per-axis symmetry flips, Gaussian jitter — and the ``_new`` variant
(common.py:331-409) that applies the same R/scale to the unprojected image
coordinates so 2D-lifted geometry stays consistent with the cloud.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def random_rotation(rng: np.random.RandomState, mode: str = "vertical") -> np.ndarray:
    if mode == "vertical":
        theta = rng.rand() * 2 * np.pi
        c, s = np.cos(theta), np.sin(theta)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    if mode == "all":
        u = rng.randn(3)
        u /= np.linalg.norm(u)
        alpha = rng.rand() * 2 * np.pi
        K = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
        R = np.eye(3) + np.sin(alpha) * K + (1 - np.cos(alpha)) * K @ K
        return R.astype(np.float32)
    return np.eye(3, dtype=np.float32)


def augment_points(
    points: np.ndarray,
    cfg,
    rng: np.random.RandomState,
    extra_xyz: Optional[np.ndarray] = None,
):
    """Rotate/scale/jitter ``points``; apply the same R/scale to
    ``extra_xyz`` (e.g. unprojected pixel positions) without jitter.

    Returns (points, extra_xyz, R, scale).
    """
    R = random_rotation(rng, cfg.augment_rotation)
    if cfg.augment_scale_anisotropic:
        scale = rng.uniform(cfg.augment_scale_min, cfg.augment_scale_max, 3)
    else:
        scale = np.full(3, rng.uniform(cfg.augment_scale_min, cfg.augment_scale_max))
    for ax, sym in enumerate(cfg.augment_symmetries):
        if sym and rng.rand() < 0.5:
            scale[ax] *= -1
    scale = scale.astype(np.float32)
    noise = (rng.randn(*points.shape) * cfg.augment_noise).astype(np.float32)
    out = points @ R.T * scale + noise
    extra = None
    if extra_xyz is not None:
        extra = extra_xyz @ R.T * scale
    return out.astype(np.float32), extra, R, scale
