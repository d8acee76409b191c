"""ContFuse-style 2D→3D feature aggregation
(``mvkpconv_tpu/models/feature_aggregation.py``).

For each 3D point, its K pixel neighbors' features ⊕ the relation feature
[Δxyz, ‖Δxyz‖²] go through a shared pointwise MLP (Dense in ``dtype``, BN
and ReLU in f32, as flax promotes) and are sum-reduced over K.
Channel-last: features (B, N, K, C), points (B, N, 3).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mvkpconv_tpu_torch.models.norm import BatchNorm


class SharedMLP(nn.Module):
    """Dense (no bias, in ``dtype``) + BN + ReLU stack, applied pointwise."""

    def __init__(self, in_channels: int, channels: Tuple[int, ...],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"dense{i}", nn.Linear(in_channels, c, bias=False))
            self.add_module(f"bn{i}", BatchNorm(c))
            in_channels = c

    def forward(self, x):
        for i in range(self.num_layers):
            dense = getattr(self, f"dense{i}")
            x = F.linear(x.to(self.dtype), dense.weight.to(self.dtype))
            x = F.relu(getattr(self, f"bn{i}")(x))
        return x


class FeatureAggregation(nn.Module):
    def __init__(self, in_channels: int = 64,
                 mlp_channels: Tuple[int, ...] = (64, 64, 64),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = SharedMLP(in_channels + 4, mlp_channels, dtype)

    def forward(self, src_xyz, tgt_xyz, feature):
        """src_xyz (B,N,K,3) pixel positions, tgt_xyz (B,N,3) points,
        feature (B,N,K,C) lifted 2D features → (B,N,C_out) f32."""
        diff = src_xyz - tgt_xyz[:, :, None, :]
        dist = (diff * diff).sum(dim=-1, keepdim=True)
        x = torch.cat([feature.float(), diff, dist], dim=-1)
        return self.mlp(x).sum(dim=2)
