"""PointNet++ single-scale-grouping segmentation network
(``mvkpconv_tpu/models/pn2.py``).

SetAbstraction (FPS → ball query → shared MLP → max over the neighbors),
FeaturePropagation (3-NN inverse-distance interpolation → shared MLP) and
the PN2SSG segmentation model at the reference's widths (pn2ssg.py:22-34:
centroids 2048/512/128/32, radii 0.1/0.2/0.4/0.8, 32 neighbors).

The index computations (FPS, ball query, the 3-NN) run under ``no_grad``;
the feature gathers are ``group_points``, so their VJPs follow the gather
transpose mode in scope (kernel K3 under ``banded`` / ``banded_bf16``).
Flax infers a Dense layer's input width; the port's ``SharedMLP`` takes it,
so each width is worked out here from the dataflow: SA i takes its input
feature width plus 3 (the JAX model's ``use_xyz``, which no tool turns
off; 3 alone without a feature), FP i the sparse level's width plus its
skip's, and FP3's skip is None (the reference drops the input feature
from the skip list). Channel-last
(B, N, C); chunks are resampled to a fixed size, so there are no masks.

The dropout before ``seg_logit`` draws its masks from the model's own
``torch.Generator``, seeded at construction, on the features' device.

Tracer spans (``tracing.py``): ``pn2`` around the forward; ``pn2.sa`` and
``pn2.fp`` with their level; inside a set abstraction ``pn2.fps`` (P1's
launch alone), ``pn2.group`` (the centroids' gather, then the neighbours'),
``pn2.ball_query`` (kernel P2's ball query on the card; the span counts
its neighbour slots and those a real hit fills) and ``pn2.sa.mlp`` (the MLP
and the max); inside a propagation ``pn2.three_nn`` (P2's 3-NN) and
``pn2.fp.mlp``; ``head``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mvkpconv_tpu_torch import tracing
from mvkpconv_tpu_torch.models.feature_aggregation import SharedMLP
from mvkpconv_tpu_torch.ops.gather import batch_index_select, group_points
from mvkpconv_tpu_torch.ops.interpolate import inverse_distance_interpolate
from mvkpconv_tpu_torch.ops.neighbors import ball_query, three_nn
from mvkpconv_tpu_torch.ops.sampling import farthest_point_sample


# the reference's widths (pn2ssg.py:22-34)
SA_CHANNELS = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
NUM_CENTROIDS = (2048, 512, 128, 32)
RADII = (0.1, 0.2, 0.4, 0.8)
MAX_NEIGHBORS = 32
FP_CHANNELS = ((256, 256), (256, 256), (256, 128), (128, 128, 128))


class SetAbstraction(nn.Module):
    def __init__(self, in_channels: int, mlp_channels: Tuple[int, ...], num_centroids: int,
                 radius: float, dtype: torch.dtype = torch.float32, level: int = 0):
        """``in_channels``: the input feature width (0: no feature); the
        grouped relative xyz is appended to it (``use_xyz``). ``level``:
        the level its spans carry."""
        super().__init__()
        self.num_centroids = num_centroids
        self.radius = radius
        self.level = level
        self.mlp = SharedMLP(in_channels + 3, mlp_channels, dtype)

    def forward(self, xyz: torch.Tensor, feature: Optional[torch.Tensor] = None):
        """xyz (B, N, 3), feature (B, N, C) → (B, M, 3), (B, M, C')."""
        with tracing.span("pn2.sa", self.level):
            with torch.no_grad():
                with tracing.span("pn2.fps"):
                    centroids = farthest_point_sample(xyz, self.num_centroids)
                with tracing.span("pn2.group"):
                    new_xyz = batch_index_select(xyz, centroids)
                with tracing.span("pn2.ball_query"):
                    idx = ball_query(new_xyz, xyz, self.radius, MAX_NEIGHBORS)
                    if tracing.on():
                        tracing.count_rows(real_slots(idx, xyz.shape[1]))
            with tracing.span("pn2.group"):
                group_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
                if feature is not None:
                    group_xyz = torch.cat([group_points(feature, idx), group_xyz], dim=-1)
            with tracing.span("pn2.sa.mlp"):
                return new_xyz, self.mlp(group_xyz).amax(dim=2)


def real_slots(idx: torch.Tensor, num_support: int) -> torch.Tensor:
    """Which of ``ball_query``'s (B, M, K) slots hold a real hit: the hits
    come in ascending index order and a short row repeats its first, so a
    slot after the first is real where it exceeds the first, and the first
    where it is not the empty row's ``num_support``."""
    return torch.cat([idx[..., :1] < num_support, idx[..., 1:] > idx[..., :1]], dim=-1)


class FeaturePropagation(nn.Module):
    def __init__(self, in_channels: int, mlp_channels: Tuple[int, ...],
                 dtype: torch.dtype = torch.float32, level: int = 0):
        """``in_channels``: the sparse features' width plus the skip's;
        ``level``: the level its spans carry."""
        super().__init__()
        self.level = level
        self.mlp = SharedMLP(in_channels, mlp_channels, dtype)

    def forward(self, dense_xyz, sparse_xyz, dense_feature, sparse_feature):
        """The sparse features at the dense points (``three_nn``, in its own
        span, then ``inverse_distance_interpolate``), ⊕ the skip, through the
        MLP."""
        with tracing.span("pn2.fp", self.level):
            with tracing.span("pn2.three_nn"):
                index, sqdist = three_nn(dense_xyz, sparse_xyz)
            x = inverse_distance_interpolate(sparse_feature, index, sqdist)
            if dense_feature is not None:
                x = torch.cat([x, dense_feature], dim=-1)
            with tracing.span("pn2.fp.mlp"):
                return self.mlp(x)


class PN2SSG(nn.Module):
    """PointNet++ SSG segmentation: points (B, N, 3) and an optional feature
    (B, N, ``in_channels``) → logits (B, N, num_classes) f32."""

    def __init__(
        self,
        num_classes: int = 20,
        in_channels: int = 0,
        num_centroids: Tuple[int, ...] = NUM_CENTROIDS,
        dropout: float = 0.5,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        """``num_centroids``: the SA levels' centroids (cut in tests and
        small card checks); ``seed``: the dropout's generator."""
        super().__init__()
        self.dropout = dropout
        self.seed = seed
        self._generator = None
        widths = [in_channels]
        for i, channels in enumerate(SA_CHANNELS):
            self.add_module(f"sa{i}", SetAbstraction(widths[-1], channels, num_centroids[i], RADII[i], dtype, i))
            widths.append(channels[-1])
        # skip widths, the input's left out (pn2ssg.py:66-69)
        skips = [0] + widths[1:]
        x = widths[-1]
        for i, channels in enumerate(FP_CHANNELS):
            self.add_module(f"fp{i}", FeaturePropagation(x + skips[-2 - i], channels, dtype, i))
            x = channels[-1]
        self.num_sa, self.num_fp = len(SA_CHANNELS), len(FP_CHANNELS)
        self.mlp_seg = SharedMLP(x, (128,), dtype)
        self.seg_logit = nn.Linear(128, num_classes)

    def generator(self, device: torch.device) -> torch.Generator:
        """The dropout's generator on ``device``, seeded with ``seed`` when
        first used there."""
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(self.seed)
        return self._generator

    def forward(self, points: torch.Tensor, feature: Optional[torch.Tensor] = None) -> torch.Tensor:
        with tracing.span("pn2"):
            xyz_list, sa_features = [points], [None]
            x = feature
            for i in range(self.num_sa):
                points, x = getattr(self, f"sa{i}")(points, x)
                xyz_list.append(points)
                sa_features.append(x)
            for i in range(self.num_fp):
                x = getattr(self, f"fp{i}")(xyz_list[-2 - i], xyz_list[-1 - i], sa_features[-2 - i], x)
            with tracing.span("head"):
                x = self.mlp_seg(x)
                if self.training and self.dropout > 0.0:
                    keep = torch.rand(x.shape, generator=self.generator(x.device), device=x.device) >= self.dropout
                    x = torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))
                return self.seg_logit(x.float())
