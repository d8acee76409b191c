"""MV-KPConv: multi-view 2D features fused into KPConv, three variants
(``mvkpconv_tpu/models/mvkpconv.py``).

  * early: the lifted 64-d 2D features are concatenated into the level-0
    input features before the KPFCNN encoder;
  * middle: two parallel encoders (``encoder_3d`` on the 3D features,
    ``encoder_2d`` on ones ⊕ the lifted features); the skip features are the
    concatenation of both streams, the bottlenecks are merged by their
    element-wise mean before one decoder;
  * late: KPConv runs on the 3D features only; the lifted features are
    concatenated with the decoder output right before the head.

The 2D network runs in the forward; with ``freeze_2d`` (the default) it stays
in eval mode when the model trains and runs under ``no_grad``, as the JAX
model runs it with ``train=False`` and stops its gradient. The lift — depth
unprojection, the projective pixel k-NN (kernel K2), one gather of pixel
xyz ⊕ features and FeatureAggregation — runs on the batch's device (a
batch without poses, or ``pixel_assoc='exact'``, takes the brute-force pixel
k-NN of ``ops/unproject.py`` instead of K2); batches
may instead carry precomputed ``knn_indices`` / ``image_xyz`` (or the whole
lifted ``feature_2d3d``). Submodules carry the flax scope names, so the
weight bridge is a name-for-name walk for every variant.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from mvkpconv_tpu_torch import tracing
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
    points_to_pixel_knn,
    points_to_pixel_knn_projective,
    unproject_depth,
)
from mvkpconv_tpu_torch.training.config import as_torch_dtype


def _middle_skip_extras(cfg3d, cfg2d):
    """Per-decoder-block extra skip width from the 2D stream: middle fusion
    concatenates the two streams' skip features, so each decoder concat block
    sees ``skip_dims_3d[layer] + skip_dims_2d[layer]``."""
    _, dec, _ = plan_architecture(cfg3d)
    _, _, skip_dims_2d = plan_architecture(cfg2d)
    return [skip_dims_2d[layer] if concat else 0 for (_n, _i, _o, _r, layer, concat) in dec]


class MVKPConv(nn.Module):
    """KPFCNN with multi-view 2D feature fusion (``cfg.fusion`` selects the
    variant).

    Batch dict (channel-last, as the JAX model takes it):
      features: (B, N0, C3d) base 3D features, C3d = in_features_dim − 64.
      images: (B, V, H, W, 3) normalized RGB.
      EITHER image_xyz (B, V, H, W, 3) + knn_indices (B, N0, K)
      OR     depth (B, V, H, W) + intrinsics (B, V, 3, 3) + poses (B, V, 4, 4).
    """

    def __init__(self, cfg, freeze_2d: bool = True):
        super().__init__()
        self.cfg = cfg
        self.freeze_2d = freeze_2d
        self.net_2d = UNetResNet34(cfg.num_classes, dtype=cfg.compute_dtype)
        self.feat_aggreg = FeatureAggregation(cfg.feature_2d_dim, dtype=cfg.compute_dtype)
        cfg3d = cfg.replace(in_features_dim=cfg.in_features_dim - cfg.feature_2d_dim)
        head_dim_extra = 0
        if cfg.fusion == "early":
            enc, dec, _ = plan_architecture(cfg)
            self.encoder = KPFCNNEncoder(cfg, enc)
            self.decoder = KPFCNNDecoder(cfg, dec)
        elif cfg.fusion == "middle":
            cfg2d = cfg.replace(in_features_dim=cfg.feature_2d_dim + 1)
            enc3, dec3, _ = plan_architecture(cfg3d)
            enc2, _, _ = plan_architecture(cfg2d)
            self.encoder_3d = KPFCNNEncoder(cfg3d, enc3)
            self.encoder_2d = KPFCNNEncoder(cfg2d, enc2)
            # the decoder takes the concatenated skips of both streams
            dec = [
                (name, in_dim + extra, out_dim, r, layer, concat)
                for (name, in_dim, out_dim, r, layer, concat), extra in zip(
                    dec3, _middle_skip_extras(cfg3d, cfg2d)
                )
            ]
            self.decoder = KPFCNNDecoder(cfg, dec)
        elif cfg.fusion == "late":
            enc, dec, _ = plan_architecture(cfg3d)
            self.encoder = KPFCNNEncoder(cfg3d, enc)
            self.decoder = KPFCNNDecoder(cfg3d, dec)
            head_dim_extra = cfg.feature_2d_dim
        else:
            raise ValueError(f"MVKPConv requires fusion in early/middle/late, got {cfg.fusion!r}")
        self.head = KPFCNNHead(cfg, dec[-1][2] + head_dim_extra)

    @property
    def encoders(self) -> Tuple[KPFCNNEncoder, ...]:
        """The encoder streams: one, or (3D, 2D) for middle fusion."""
        if self.cfg.fusion == "middle":
            return (self.encoder_3d, self.encoder_2d)
        return (self.encoder,)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_2d:
            self.net_2d.eval()
        return self

    def lift_2d_features(self, batch: Dict[str, torch.Tensor], points: torch.Tensor):
        """UNet over all views → gather K pixels per point → aggregate to 64-d."""
        with tracing.span("lift"):
            cfg = self.cfg
            images = batch["images"]
            b, v, h, w, _ = images.shape
            if "image_xyz" in batch:
                image_xyz = batch["image_xyz"]
            else:
                with tracing.span("lift.unproject"):
                    image_xyz, _ = unproject_depth(batch["depth"], batch["intrinsics"], batch["poses"])
            if "knn_indices" in batch:
                knn_idx = batch["knn_indices"]
            elif cfg.pixel_assoc == "projective" and "poses" in batch:
                cfg.port_option("pixel_select")
                with tracing.span("lift.pixel_select"):
                    knn_idx = points_to_pixel_knn_projective(
                        points, image_xyz, batch["intrinsics"], batch["poses"],
                        cfg.pixel_knn, window=cfg.pixel_window,
                        patch_dtype=as_torch_dtype(cfg.pixel_patch_dtype),
                    )
            else:  # no poses, or pixel_assoc='exact': the global nearest pixels
                with tracing.span("lift.pixel_select"):
                    knn_idx = points_to_pixel_knn(points, image_xyz, cfg.pixel_knn)
            with tracing.span("lift.unet"), torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_2d):
                preds = self.net_2d(images.reshape(b * v, h, w, 3))
            with tracing.span("lift.gather"):
                feat = preds["feature"].reshape(b, v * h * w, -1).to(cfg.compute_dtype)
                xyz_src = image_xyz.reshape(b, v * h * w, 3).float()
                pixel_xyz, pixel_feat = group_points_joint(xyz_src, feat, knn_idx)
            with tracing.span("lift.aggregate"):
                return self.feat_aggreg(pixel_xyz, points, pixel_feat)

    def forward(self, batch: Dict[str, torch.Tensor], pyr: Pyramid) -> torch.Tensor:
        """Per-point logits (B, N0, num_classes), f32."""
        with tracing.span("model"):
            cfg = self.cfg
            points0 = pyr.points[0]
            if "feature_2d3d" in batch:
                feat_2d3d = batch["feature_2d3d"].float().detach()
            else:
                feat_2d3d = self.lift_2d_features(batch, points0)
            base = batch["features"].float()
            # one influence cache for every rigid conv block, and for both
            # middle-fusion encoders (the same geometry per level)
            infl = make_influence_cache(cfg, (self.encoders[0].plan, self.decoder.plan), pyr)
            if cfg.fusion == "early":
                with tracing.span("encoder"):
                    x, skips = self.encoder(torch.cat([base, feat_2d3d], dim=-1), pyr, infl)
            elif cfg.fusion == "middle":
                with tracing.span("encoder_3d"):
                    x3d, skips3d = self.encoder_3d(base, pyr, infl)
                with tracing.span("encoder_2d"):
                    ones = torch.ones_like(feat_2d3d[..., :1])
                    x2d, skips2d = self.encoder_2d(torch.cat([ones, feat_2d3d], dim=-1), pyr, infl)
                x = 0.5 * (x3d + x2d)
                skips = [torch.cat([a, b], dim=-1) for a, b in zip(skips3d, skips2d)]
            else:  # late
                with tracing.span("encoder"):
                    x, skips = self.encoder(base, pyr, infl)
            with tracing.span("decoder"):
                x = self.decoder(x, skips, pyr, infl)
            if cfg.fusion == "late":
                x = torch.cat([x, feat_2d3d], dim=-1)
            with tracing.span("head"):
                return self.head(x, pyr.masks[0])
