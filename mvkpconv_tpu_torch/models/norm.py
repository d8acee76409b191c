"""Batch normalization with flax ``nn.BatchNorm`` inference numerics.

At eval flax computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
float32 (the statistics are f32, so a bf16 input promotes) and casts the
result to the layer's ``dtype`` — or leaves it f32 when ``dtype`` is None.
This module does the same. Its state is named like ``nn.BatchNorm2d``'s
(``weight``, ``bias``, ``running_mean``, ``running_var``) without the
``num_batches_tracked`` counter, which flax does not have. Training-mode
statistics are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        dtype: Optional[torch.dtype] = None,
        channel_axis: int = -1,
        epsilon: float = 1e-5,
    ):
        super().__init__()
        self.out_dtype = dtype
        self.channel_axis = channel_axis
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm training statistics are not ported yet "
                "(ROADMAP queue 1, P6); call .eval()"
            )
        shape = [1] * x.dim()
        shape[self.channel_axis] = x.shape[self.channel_axis]
        mul = torch.rsqrt(self.running_var + self.epsilon) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        y = y + self.bias.view(shape)
        return y if self.out_dtype is None else y.to(self.out_dtype)
