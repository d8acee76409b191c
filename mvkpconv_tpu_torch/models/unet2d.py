"""UNet on a ResNet34 encoder for 2D segmentation (``mvkpconv_tpu/models/unet2d.py``).

Takes and returns channel-last images like the JAX model — (B, H, W, 3) in,
{'seg_logit': (B, H, W, num_classes), 'feature': (B, H, W, 64)} out — and
runs NCHW inside. The input is zero-padded to a multiple of 16 and the
output cropped back. Convolutions run in ``dtype``; so does BN at eval
(computed in f32, cast to ``dtype``, as flax does). The 1×1 ``logit`` conv
has no dtype in flax and runs in f32. Submodule names are the flax scopes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvkpconv_tpu_torch.models.norm import BatchNorm

RESNET34_LAYERS = ((64, 3), (128, 4), (256, 6), (512, 3))


class Conv2d(nn.Conv2d):
    """Conv whose f32 parameters are cast to the input's dtype at the call,
    as flax casts its kernel to the layer dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed conv with the same call-time cast. The weight is torch's
    (in, out, kh, kw); ``convert.py`` flips flax's spatial axes into it."""

    def forward(self, x):
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )


def _conv(cin, cout, k, stride=1, padding=0, bias=False):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


def _bn(c, dtype):
    return BatchNorm(c, dtype=dtype, channel_axis=1)


class BasicBlock(nn.Module):
    """torchvision ResNet BasicBlock (two 3×3 convs + identity/projection)."""

    def __init__(self, in_filters: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(in_filters, filters, 3, stride, 1)
        self.bn1 = _bn(filters, dtype)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = _bn(filters, dtype)
        if stride != 1 or in_filters != filters:
            self.proj = _conv(in_filters, filters, 1, stride)
            self.proj_bn = _bn(filters, dtype)
        else:
            self.proj = self.proj_bn = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(y + residual)


class _DeconvBlock(nn.Module):
    """2×2 stride-2 transposed conv (with bias) + BN + ReLU."""

    def __init__(self, cin, filters, dtype):
        super().__init__()
        self.deconv = ConvTranspose2d(cin, filters, 2, stride=2)
        self.bn = _bn(filters, dtype)

    def forward(self, x):
        return F.relu(self.bn(self.deconv(x)))


class _ConvBlock(nn.Module):
    def __init__(self, cin, filters, dtype):
        super().__init__()
        self.conv = _conv(cin, filters, 3, 1, 1)
        self.bn = _bn(filters, dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class UNetResNet34(nn.Module):
    """Returns {'seg_logit': (B,H,W,num_classes), 'feature': (B,H,W,64)}."""

    def __init__(self, num_classes: int = 20, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder0 = _conv(3, 64, 7, 1, 3)
        self.bn0 = _bn(64, dtype)
        cin = 64
        for stage, (filters, depth) in enumerate(RESNET34_LAYERS):
            for i in range(depth):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(f"layer{stage + 1}_{i}", BasicBlock(cin, filters, stride, dtype))
                cin = filters
        skip_c = (256, 128, 64, 64)  # layer3, layer2, layer1, stem
        for stage, filters in enumerate((256, 128, 64, 64)):
            self.add_module(f"deconv{4 - stage}", _DeconvBlock(cin, filters, dtype))
            self.add_module(f"decoder{3 - stage}", _ConvBlock(filters + skip_c[stage], filters, dtype))
            cin = filters
        self.logit = _conv(64, num_classes, 1, bias=True)

    def forward(self, image: torch.Tensor):
        h, w = image.shape[1], image.shape[2]
        pad_h, pad_w = (-h) % 16, (-w) % 16
        x = image.permute(0, 3, 1, 2)
        x = F.pad(x, (0, pad_w, 0, pad_h)).to(self.dtype)
        x = F.relu(self.bn0(self.encoder0(x)))
        skips = [x]  # full res, 64ch
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage, (_, depth) in enumerate(RESNET34_LAYERS):
            for i in range(depth):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
            if stage < 3:
                skips.append(x)
        for stage in range(4):
            x = getattr(self, f"deconv{4 - stage}")(x)
            x = torch.cat([x, skips[3 - stage]], dim=1)
            x = getattr(self, f"decoder{3 - stage}")(x)
        x = x[:, :, :h, :w]
        seg_logit = self.logit(x.float())
        return {
            "seg_logit": seg_logit.permute(0, 2, 3, 1),
            "feature": x.permute(0, 2, 3, 1),
        }
