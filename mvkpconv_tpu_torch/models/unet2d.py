"""UNet on a ResNet34 encoder for 2D segmentation (``mvkpconv_tpu/models/unet2d.py``).

Takes and returns channel-last images like the JAX model — (B, H, W, 3) in,
{'seg_logit': (B, H, W, num_classes), 'feature': (B, H, W, 64)} out — and
runs NCHW inside. The input is zero-padded to a multiple of 16 and the
output cropped back. Convolutions cast their input and weights to ``dtype``
and run there, as flax's ``nn.Conv(dtype=...)`` does. BN computes in f32 and
casts its output to ``dtype`` at eval; in training mode it returns f32
(the JAX UNet's ``_bn``: ``dtype=None if train``), so residual sums, skips
and the ``feature`` output are f32 when the UNet trains. The 1×1 ``logit``
conv has no dtype in flax and runs in f32. Submodule names are the flax
scopes.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from mvkpconv_tpu_torch.models.norm import BatchNorm

RESNET34_LAYERS = ((64, 3), (128, 4), (256, 6), (512, 3))


class Conv2d(nn.Conv2d):
    """Conv that casts its input and its f32 parameters to ``dtype`` at the
    call, as flax casts both to the layer dtype."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed conv with the same call-time cast. The weight is torch's
    (in, out, kh, kw); ``convert.py`` flips flax's spatial axes into it."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )


def _conv(cin, cout, k, stride=1, padding=0, bias=False, dtype=torch.float32):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias, dtype=dtype)


def _bn(c, dtype):
    return BatchNorm(c, dtype=dtype, channel_axis=1, f32_in_train=True)


class BasicBlock(nn.Module):
    """torchvision ResNet BasicBlock (two 3×3 convs + identity/projection)."""

    def __init__(self, in_filters: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(in_filters, filters, 3, stride, 1, dtype=dtype)
        self.bn1 = _bn(filters, dtype)
        self.conv2 = _conv(filters, filters, 3, 1, 1, dtype=dtype)
        self.bn2 = _bn(filters, dtype)
        if stride != 1 or in_filters != filters:
            self.proj = _conv(in_filters, filters, 1, stride, dtype=dtype)
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
        self.deconv = ConvTranspose2d(cin, filters, 2, stride=2, dtype=dtype)
        self.bn = _bn(filters, dtype)

    def forward(self, x):
        return F.relu(self.bn(self.deconv(x)))


class _ConvBlock(nn.Module):
    def __init__(self, cin, filters, dtype):
        super().__init__()
        self.conv = _conv(cin, filters, 3, 1, 1, dtype=dtype)
        self.bn = _bn(filters, dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class UNetResNet34(nn.Module):
    """Returns {'seg_logit': (B,H,W,num_classes), 'feature': (B,H,W,64)}."""

    def __init__(self, num_classes: int = 20, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder0 = _conv(3, 64, 7, 1, 3, dtype=dtype)
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
        x = F.pad(x, (0, pad_w, 0, pad_h))
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
        seg_logit = self.logit(x)
        return {
            "seg_logit": seg_logit.permute(0, 2, 3, 1),
            "feature": x.permute(0, 2, 3, 1),
        }


def load_torch_resnet34_encoder(model: UNetResNet34, state_dict) -> UNetResNet34:
    """torchvision ResNet34 weights into the UNet's encoder, in place
    (``mvkpconv_tpu/models/unet2d.py:load_torch_resnet34_encoder``; the
    reference builds its 2D net on ``resnet34(pretrained)``,
    mvpnet/models/unet_resnet34.py:17-31, ``conv1.weight`` into the stride-1
    stem). Kernels stay OIHW; BN ``weight``/``bias``/running statistics go
    to the same names; the decoder and the logit conv are left as they are.

    ``state_dict``: a ``resnet34().state_dict()`` (tensors or numpy arrays)
    or the path of a ``torch.save``d one (a dict under ``'state_dict'`` is
    unwrapped). Raises on a missing key or a shape that differs.
    """
    if not isinstance(state_dict, Mapping):
        raw = torch.load(str(state_dict), map_location="cpu", weights_only=True)
        state_dict = raw["state_dict"] if "state_dict" in raw else raw
    target = model.state_dict()
    new = {}

    def put(name: str, key: str):
        if name not in target:
            raise KeyError(f"the UNet has no {name!r}")
        val = torch.as_tensor(state_dict[key])
        if tuple(val.shape) != tuple(target[name].shape):
            raise ValueError(f"{name}: torch weight shape {tuple(val.shape)} != {tuple(target[name].shape)}")
        new[name] = val.to(target[name].dtype)

    def put_bn(name: str, prefix: str):
        for ours, theirs in (("weight", "weight"), ("bias", "bias"),
                             ("running_mean", "running_mean"), ("running_var", "running_var")):
            put(f"{name}.{ours}", f"{prefix}.{theirs}")

    put("encoder0.weight", "conv1.weight")
    put_bn("bn0", "bn1")
    for stage, (_, depth) in enumerate(RESNET34_LAYERS):
        for i in range(depth):
            t, f = f"layer{stage + 1}.{i}", f"layer{stage + 1}_{i}"
            put(f"{f}.conv1.weight", f"{t}.conv1.weight")
            put_bn(f"{f}.bn1", f"{t}.bn1")
            put(f"{f}.conv2.weight", f"{t}.conv2.weight")
            put_bn(f"{f}.bn2", f"{t}.bn2")
            if f"{t}.downsample.0.weight" in state_dict:
                put(f"{f}.proj.weight", f"{t}.downsample.0.weight")
                put_bn(f"{f}.proj_bn", f"{t}.downsample.1")
    model.load_state_dict(new, strict=False)
    return model
