"""Batch normalization with flax ``nn.BatchNorm`` numerics.

Eval: flax computes ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
float32 (the statistics are f32, so a bf16 input promotes) and casts the
result to the layer's ``dtype``, or leaves it f32 when ``dtype`` is None.
``f32_in_train`` leaves the result f32 in training mode whatever ``dtype``
is: the JAX UNet builds its BN with ``dtype=None`` under train
(``mvkpconv_tpu/models/unet2d.py:_bn``).

Train: the statistics are taken over every axis but the channel, with no
mask, reduced in f32, the variance in flax's fast biased form
``max(mean(x²) − mean(x)², 0)``; gradients flow through them. The running
statistics update as ``ra ← m·ra + (1 − m)·batch`` with flax's momentum
m = 0.9 (torch's 0.1), the variance biased. ``nn.BatchNorm2d`` keeps the
unbiased variance in its running statistics, so it is not used.

State is named like ``nn.BatchNorm2d``'s (``weight``, ``bias``,
``running_mean``, ``running_var``) without the ``num_batches_tracked``
counter, which flax does not have.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

MOMENTUM = 0.9  # flax's: the running statistics keep 0.9 of themselves


class BatchNorm(nn.Module):
    def __init__(
        self,
        num_features: int,
        dtype: Optional[torch.dtype] = None,
        channel_axis: int = -1,
        epsilon: float = 1e-5,
        f32_in_train: bool = False,
    ):
        super().__init__()
        self.out_dtype = dtype
        self.f32_in_train = f32_in_train
        self.channel_axis = channel_axis
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.channel_axis % x.dim()
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        xf = x.float()
        if self.training:
            dims = tuple(d for d in range(x.dim()) if d != axis)
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * mean)
                self.running_var.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        y = y + self.bias.view(shape)
        if self.out_dtype is None or (self.training and self.f32_in_train):
            return y
        return y.to(self.out_dtype)
