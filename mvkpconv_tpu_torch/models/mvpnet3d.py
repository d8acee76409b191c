"""MVPNet: multi-view 2D features lifted onto points, then PointNet++
(``mvkpconv_tpu/models/mvpnet3d.py``).

The UNet runs over every view; each point takes its 3 nearest pixels (the
projective pixel k-NN, kernel K2, where the batch has poses; the
brute-force k-NN of ``ops/unproject.py`` where it has none; or the batch's
``knn_indices``); the pixels' features and positions are gathered,
FeatureAggregation lifts them to 64 channels, and PN2SSG segments the
points. With ``freeze_2d`` (the default, the reference's FROZEN_PATTERNS
net_2d) the UNet stays in eval mode when the model trains and runs without
gradients, as the JAX model runs it with ``train=False`` and stops its
gradient; the optimizer leaves ``net_2d`` out.

Tracer spans (``tracing.py``), named as ``MVKPConv``'s: ``model`` >
``lift`` (> ``lift.unproject``, ``lift.pixel_select``, ``lift.unet``,
``lift.gather``, ``lift.aggregate``) and PN2SSG's ``pn2``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mvkpconv_tpu_torch import tracing
from mvkpconv_tpu_torch.models.feature_aggregation import FeatureAggregation
from mvkpconv_tpu_torch.models.pn2 import PN2SSG
from mvkpconv_tpu_torch.models.unet2d import UNetResNet34
from mvkpconv_tpu_torch.ops.gather import group_points
from mvkpconv_tpu_torch.ops.unproject import (
    points_to_pixel_knn,
    points_to_pixel_knn_projective,
    unproject_depth,
)


class MVPNet3D(nn.Module):
    """Batch dict: points (B, N, 3), images (B, V, H, W, 3), and EITHER
    image_xyz (B, V, H, W, 3) [+ knn_indices (B, N, 3)] OR depth (B, V, H, W)
    + intrinsics (B, V, 3, 3) + poses (B, V, 4, 4). ``pn2`` passes on to
    ``PN2SSG`` (its centroids and dropout)."""

    def __init__(self, num_classes: int = 20, freeze_2d: bool = True,
                 dtype: torch.dtype = torch.float32, seed: int = 0, **pn2):
        super().__init__()
        self.freeze_2d = freeze_2d
        self.net_2d = UNetResNet34(num_classes, dtype=dtype)
        # the UNet's 64 feature channels, lifted to 64 (mvpnet_3d.py:73-135)
        self.feat_aggreg = FeatureAggregation(64, dtype=dtype)
        self.net_3d = PN2SSG(num_classes, in_channels=64, dtype=dtype, seed=seed, **pn2)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_2d:
            self.net_2d.eval()
        return self

    def lift_2d_features(self, images, image_xyz, knn_indices):
        """UNet over all views, then each point's K pixels: (feature (B, N,
        K, 64), pixel xyz (B, N, K, 3))."""
        b, v, h, w, _ = images.shape
        with tracing.span("lift.unet"), torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_2d):
            feat = self.net_2d(images.reshape(b * v, h, w, 3))["feature"]
        with tracing.span("lift.gather"):
            feat = feat.reshape(b, v * h * w, -1)
            feature_2d = group_points(feat, knn_indices)
            pixel_xyz = group_points(image_xyz.reshape(b, v * h * w, 3), knn_indices)
        return feature_2d, pixel_xyz

    def lift(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The lifted 2D features of the points, (B, N, 64) f32."""
        with tracing.span("lift"):
            points = batch["points"]
            if "image_xyz" in batch:
                image_xyz = batch["image_xyz"]
            else:
                with tracing.span("lift.unproject"):
                    image_xyz, _ = unproject_depth(batch["depth"], batch["intrinsics"], batch["poses"])
            if "knn_indices" in batch:
                knn_indices = batch["knn_indices"]
            elif "poses" in batch:
                with tracing.span("lift.pixel_select"):
                    knn_indices = points_to_pixel_knn_projective(
                        points, image_xyz, batch["intrinsics"], batch["poses"], 3)
            else:
                with tracing.span("lift.pixel_select"):
                    knn_indices = points_to_pixel_knn(points, image_xyz, 3)
            feature_2d, pixel_xyz = self.lift_2d_features(batch["images"], image_xyz, knn_indices)
            with tracing.span("lift.aggregate"):
                return self.feat_aggreg(pixel_xyz, points, feature_2d)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-point logits (B, N, num_classes), f32."""
        with tracing.span("model"):
            return self.net_3d(batch["points"], self.lift(batch))
