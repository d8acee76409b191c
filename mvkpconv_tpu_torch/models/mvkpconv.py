"""MV-KPConv early fusion (``mvkpconv_tpu/models/mvkpconv.py``).

Lifted 64-d 2D features are concatenated into the level-0 input features
before the KPFCNN encoder. The 2D network runs in the forward (frozen by
default). The lift — depth unprojection, the projective pixel k-NN (kernel
K2), one gather of pixel xyz ⊕ features and FeatureAggregation — runs on
the batch's device; batches may instead carry precomputed ``knn_indices``
/ ``image_xyz`` (or the whole lifted ``feature_2d3d``).

Middle and late fusion are not ported yet (ROADMAP queue 1, P7 item 1).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mvkpconv_tpu_torch.models.feature_aggregation import FeatureAggregation
from mvkpconv_tpu_torch.models.kpfcnn import (
    KPFCNNDecoder,
    KPFCNNEncoder,
    KPFCNNHead,
    make_influence_cache,
    plan_architecture,
)
from mvkpconv_tpu_torch.models.unet2d import UNetResNet34
from mvkpconv_tpu_torch.ops.gather import group_points_joint
from mvkpconv_tpu_torch.ops.pyramid import Pyramid
from mvkpconv_tpu_torch.ops.unproject import (
    points_to_pixel_knn_projective,
    unproject_depth,
)
from mvkpconv_tpu_torch.training.config import as_torch_dtype


class MVKPConv(nn.Module):
    """KPFCNN with multi-view 2D feature fusion (``cfg.fusion='early'``).

    Batch dict (channel-last, as the JAX model takes it):
      features: (B, N0, C3d) base 3D features, C3d = in_features_dim − 64.
      images: (B, V, H, W, 3) normalized RGB.
      EITHER image_xyz (B, V, H, W, 3) + knn_indices (B, N0, K)
      OR     depth (B, V, H, W) + intrinsics (B, V, 3, 3) + poses (B, V, 4, 4).
    """

    def __init__(self, cfg, freeze_2d: bool = True):
        super().__init__()
        if cfg.fusion in ("middle", "late"):
            raise NotImplementedError(
                f"fusion={cfg.fusion!r} is not ported yet (ROADMAP queue 1, P7 item 1)"
            )
        if cfg.fusion != "early":
            raise ValueError(f"MVKPConv requires fusion in early/middle/late, got {cfg.fusion!r}")
        self.cfg = cfg
        self.freeze_2d = freeze_2d
        self.net_2d = UNetResNet34(cfg.num_classes, dtype=cfg.compute_dtype)
        self.feat_aggreg = FeatureAggregation(cfg.feature_2d_dim, dtype=cfg.compute_dtype)
        enc, dec, _ = plan_architecture(cfg)
        self.encoder = KPFCNNEncoder(cfg, enc)
        self.decoder = KPFCNNDecoder(cfg, dec)
        self.head = KPFCNNHead(cfg, dec[-1][2])

    def lift_2d_features(self, batch: Dict[str, torch.Tensor], points: torch.Tensor):
        """UNet over all views → gather K pixels per point → aggregate to 64-d."""
        cfg = self.cfg
        images = batch["images"]
        b, v, h, w, _ = images.shape
        if "image_xyz" in batch:
            image_xyz = batch["image_xyz"]
        else:
            image_xyz, _ = unproject_depth(batch["depth"], batch["intrinsics"], batch["poses"])
        if "knn_indices" in batch:
            knn_idx = batch["knn_indices"]
        elif cfg.pixel_assoc == "projective" and "poses" in batch:
            cfg.port_option("pixel_select")
            knn_idx = points_to_pixel_knn_projective(
                points, image_xyz, batch["intrinsics"], batch["poses"],
                cfg.pixel_knn, window=cfg.pixel_window,
                patch_dtype=as_torch_dtype(cfg.pixel_patch_dtype),
            )
        else:
            raise NotImplementedError(
                "brute-force pixel association (pixel_assoc='exact') is not "
                "ported yet (ROADMAP queue 1, P7 item 7)"
            )
        preds = self.net_2d(images.reshape(b * v, h, w, 3))
        feat = preds["feature"].reshape(b, v * h * w, -1).to(cfg.compute_dtype)
        if self.freeze_2d:
            feat = feat.detach()
        xyz_src = image_xyz.reshape(b, v * h * w, 3).float()
        pixel_xyz, pixel_feat = group_points_joint(xyz_src, feat, knn_idx)
        return self.feat_aggreg(pixel_xyz, points, pixel_feat)

    def forward(self, batch: Dict[str, torch.Tensor], pyr: Pyramid) -> torch.Tensor:
        """Per-point logits (B, N0, num_classes), f32."""
        points0 = pyr.points[0]
        if "feature_2d3d" in batch:
            feat_2d3d = batch["feature_2d3d"].float().detach()
        else:
            feat_2d3d = self.lift_2d_features(batch, points0)
        infl = make_influence_cache(self.cfg, (self.encoder.plan, self.decoder.plan), pyr)
        x = torch.cat([batch["features"].float(), feat_2d3d], dim=-1)
        x, skips = self.encoder(x, pyr, infl)
        x = self.decoder(x, skips, pyr, infl)
        return self.head(x, pyr.masks[0])
