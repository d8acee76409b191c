"""Static-budget calibration: a copy of ``mvkpconv_tpu/data/calibration.py``
over the port's ``spheres.grid_subsample_np`` (``tests/test_torch_native.py``
holds its dict equal to the original's).

Replaces the reference's runtime calibration (ScanNet_sphere_color.py:1272
``sampler.calibration``: a P-controller on the batch point budget plus
90th-percentile neighbor-count histograms cached in pickles). The budgets
are static, so calibration runs once up front: sample spheres,
build exact-neighbor pyramids on the host, and report per-level point counts
and neighbor-count percentiles to fill ``KPConfig.num_points`` /
``conv_neighbors`` / ``pool_neighbors``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


def _round_up(x: float, multiple: int) -> int:
    return int(-(-x // multiple) * multiple)


def calibrate_budgets(
    dataset,
    num_spheres: int = 32,
    point_percentile: float = 98.0,
    neighbor_percentile: float = 90.0,
    point_multiple: int = 256,
) -> Dict[str, tuple]:
    """Measure point/neighbor statistics over sampled spheres.

    Args:
      dataset: a SphereDataset (training=False recommended).
      num_spheres: sample size.
      point_percentile: per-level point budget percentile (padding covers
        the rest; the reference instead packed variable batches).
      neighbor_percentile: neighbor-count percentile (the reference's
        "90% untouched" criterion, ScanNet_sphere.py:1326-1576).

    Returns:
      dict with 'num_points', 'conv_neighbors', 'pool_neighbors' tuples
      ready to drop into KPConfig.replace(...).
    """
    from mvkpconv_tpu_torch.data.spheres import grid_subsample_np

    cfg = dataset.cfg
    spec = cfg.pyramid_spec()
    levels = spec.num_levels
    counts = [[] for _ in range(levels)]
    conv_counts = [[] for _ in range(levels)]
    pool_counts = [[] for _ in range(levels - 1)]
    # budgets at the deform-WIDENED radii (deform_radius vs conv_radius) —
    # the reference calibrates larger limits exactly where a layer is
    # deformable (big_neighborhood_filter, datasets/common.py:411-421)
    dconv_counts = [[] for _ in range(levels)]
    dpool_counts = [[] for _ in range(levels - 1)]

    def count_within(d2, r):
        return np.quantile((d2 < r**2).sum(1), 0.99)

    for _ in range(num_spheres):
        item = dataset.sample_sphere()
        pts = item["points"][item["mask"]]
        level_pts = [pts]
        for l in range(levels):
            p = level_pts[l]
            counts[l].append(len(p))
            rc = spec.cell_size(l) * spec.conv_radius
            rd = spec.cell_size(l) * spec.deform_radius
            d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
            conv_counts[l].append(count_within(d2, rc))
            dconv_counts[l].append(count_within(d2, rd))
            if l + 1 < levels:
                sub, _, _ = grid_subsample_np(
                    p, p, np.zeros(len(p), np.int32), spec.cell_size(l + 1), 1
                )
                d2p = ((sub[:, None] - p[None]) ** 2).sum(-1)
                pool_counts[l].append(count_within(d2p, rc))
                dpool_counts[l].append(count_within(d2p, rd))
                level_pts.append(sub)

    def budget(per_level):
        return tuple(
            int(np.ceil(np.percentile(c, neighbor_percentile)))
            for c in per_level
        )

    num_points = tuple(
        _round_up(np.percentile(c, point_percentile), point_multiple)
        for c in counts
    )
    return {
        "num_points": num_points,
        "conv_neighbors": budget(conv_counts),
        "pool_neighbors": budget(pool_counts),
        "deform_conv_neighbors": budget(dconv_counts),
        "deform_pool_neighbors": budget(dpool_counts),
    }
