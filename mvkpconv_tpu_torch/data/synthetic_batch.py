"""Synthetic sphere batch (numpy), the batch of ``bench.py`` and
``__graft_entry__.entry``.

A copy of ``__graft_entry__._make_batch``, which the port cannot import (that
module imports jax at top level). Points are uniform in the input sphere's
bounding cube and sorted by voxel id (x-major), as the data pipeline emits
them; depth maps have two invalid rows per view. The features are
``cfg.base_feature_dim`` wide, the original's width on every fusion
configuration and the baseline's (``fusion='none'``) too. A test pins it to
the original.
"""

from __future__ import annotations

import numpy as np


def make_batch(cfg, b: int, rng: np.random.RandomState) -> dict:
    n0 = cfg.num_points[0]
    v, h, w = cfg.num_views, cfg.image_height, cfg.image_width
    pts = rng.rand(b, n0, 3).astype(np.float32) * cfg.in_radius - cfg.in_radius / 2
    cell = cfg.first_subsampling_dl
    for i in range(b):
        vox = np.floor(pts[i] / cell).astype(np.int64)
        vox -= vox.min(0)
        key = (vox[:, 0] << 40) + (vox[:, 1] << 20) + vox[:, 2]
        pts[i] = pts[i][np.argsort(key, kind="stable")]
    mask = np.ones((b, n0), bool)
    depth = (rng.rand(b, v, h, w) * 3.0).astype(np.float32)
    depth[:, :, :2] = 0.0
    K = np.zeros((b, v, 3, 3), np.float32)
    K[..., 0, 0] = K[..., 1, 1] = 0.6 * w
    K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = w / 2, h / 2, 1.0
    return {
        "points": np.where(mask[..., None], pts, 1e6).astype(np.float32),
        "mask": mask,
        "features": rng.randn(b, n0, cfg.base_feature_dim).astype(np.float32),
        "labels": rng.randint(0, cfg.num_classes, (b, n0)).astype(np.int32),
        "images": rng.rand(b, v, h, w, 3).astype(np.float32),
        "depth": depth,
        "intrinsics": K,
        "poses": np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1)),
    }
