"""Seeded parameter initialization with the flax defaults (where
``mvkpconv_tpu/training/init.py`` runs the modules' flax initializers under
jit, this module writes the same initializers out).

Conv, transposed-conv and Dense kernels: LeCun normal (truncated normal,
variance 1/fan_in, fan_in over the input channels and the window); KPConv
weights: normal with std sqrt(2 / (Cin·M)); biases zero; BN scale one,
statistics (0, 1). All draws come from one ``torch.Generator`` on the
parameters' device, so a seed fixes the weights.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mvkpconv_tpu_torch.models.blocks import KPConvLayer, MaskedBatchNorm
from mvkpconv_tpu_torch.models.norm import BatchNorm

# std of a unit normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _lecun(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Initialize every parameter and statistic of ``model`` from ``seed``."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.ConvTranspose2d):  # weight (in, out, kh, kw)
            _lecun(mod.weight, mod.weight.shape[0] * mod.weight[0, 0].numel(), gen)
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):  # weight (out, in, ...)
            _lecun(mod.weight, mod.weight[0].numel(), gen)
        elif isinstance(mod, KPConvLayer):
            m, cin, _ = mod.weights.shape
            mod.weights.normal_(0.0, math.sqrt(2.0 / (cin * m)), generator=gen)
        elif isinstance(mod, (BatchNorm, MaskedBatchNorm)):
            if hasattr(mod, "weight"):
                mod.weight.fill_(1.0)
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    return model
