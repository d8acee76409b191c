"""3-NN feature interpolation (``mvkpconv_tpu/ops/interpolate.py``): the
FeaturePropagation layers' inverse-distance weights over the 3 nearest key
points. The gather is ``group_points``, so under the ``banded`` modes its
VJP is kernel K3.
"""

from __future__ import annotations

import torch

from mvkpconv_tpu_torch.ops.gather import group_points
from mvkpconv_tpu_torch.ops.neighbors import knn


def feature_interpolate(
    features: torch.Tensor, index: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """Σ_k weight[..., k] · features[index[..., k]]: (B, Ns, C) features,
    (B, Nq, K) indices and weights → (B, Nq, C)."""
    return (group_points(features, index) * weight[..., None]).sum(dim=-2)


EPS = 1e-10  # the reference's floor on d² (pn2/modules.py:135-142)


def three_nn_interpolate(
    query_xyz: torch.Tensor, key_xyz: torch.Tensor, key_features: torch.Tensor
) -> torch.Tensor:
    """Key features at the query points: weights 1/max(d², EPS) over the 3
    nearest keys, normalized (the reference's FeatureInterpolator). d² is
    the expansion form of ``knn``: a query that coincides with a key gets 0
    there, and so weight 1/EPS, as in the JAX package."""
    index, sqdist = knn(query_xyz, key_xyz, 3)
    inv = 1.0 / sqdist.clamp(min=EPS)
    weight = inv / ((inv[..., 0:1] + inv[..., 1:2]) + inv[..., 2:3])
    return feature_interpolate(key_features, index, weight.to(key_features.dtype))
