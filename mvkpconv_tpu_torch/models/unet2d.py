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

Two paths, chosen in :meth:`UNetResNet34.forward` by what the call can
observe. A forward that needs no gradient (grad disabled, or no parameter
and not the image requiring one) of a UNet in eval mode computing in
float32 with cuDNN's TF32 off (``torch.backends.cudnn.allow_tf32`` False,
as the benchmark's configurations state their precision), the frozen UNet
of every fusion there, runs each convolution site as one
``mvkpconv::unet_conv`` (K5, ``ops/kernels/unet_conv.py``) on NHWC
activations: the bias, the eval BN, the residual, the ReLU, the decoder's
concat, the image's padding and the crop go into that site's launch, and the
``feature`` output comes out contiguous at the image's size. Every other
forward (training mode, a gradient through the UNet, bf16, or TF32 allowed,
PyTorch's default, where cuDNN's single-pass TF32 is what the caller asked
for) runs the modules.
On the CPU the two give the same bits. ``UNetResNet34.fused_calls`` and
``.module_calls`` count the forwards of each path.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from mvkpconv_tpu_torch.models.norm import BatchNorm
from mvkpconv_tpu_torch.ops.kernels.unet_conv import unet_conv

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
    """torchvision ResNet BasicBlock (two 3×3 convs + identity/projection);
    :meth:`UNetResNet34._walk` runs it."""

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


class _DeconvBlock(nn.Module):
    """2×2 stride-2 transposed conv (with bias) + BN + ReLU."""

    def __init__(self, cin, filters, dtype):
        super().__init__()
        self.deconv = ConvTranspose2d(cin, filters, 2, stride=2, dtype=dtype)
        self.bn = _bn(filters, dtype)


class _ConvBlock(nn.Module):
    """3×3 conv + BN + ReLU of the decoder, on the upsampled map ⊕ the skip."""

    def __init__(self, cin, filters, dtype):
        super().__init__()
        self.conv = _conv(cin, filters, 3, 1, 1, dtype=dtype)
        self.bn = _bn(filters, dtype)


def _site(conv, bn, x, *, relu=True, **kw):
    """One conv (or transposed conv) with its BN as K5, NHWC in and out."""
    transposed = isinstance(conv, nn.ConvTranspose2d)
    return unet_conv(x, conv.weight, conv.bias, bn, stride=conv.stride[0], padding=conv.padding[0],
                     transposed=transposed, relu=relu, **kw)


def _module_site(conv, bn, x, *, relu=True, skip=None, residual=None, out_size=None):
    """The same site on the modules, NCHW in and out: the concat with the
    skip, the conv (its input zero-padded at the bottom and right where
    ``out_size`` needs more), the BN, the residual, the ReLU, then a crop
    to ``out_size``."""
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    if out_size is not None:
        k, pad = conv.kernel_size[0], conv.padding[0]
        eh = max(0, out_size[0] - 1 + k - 2 * pad - x.shape[2])
        ew = max(0, out_size[1] - 1 + k - 2 * pad - x.shape[3])
        if eh or ew:
            x = F.pad(x, (0, ew, 0, eh))
    y = conv(x)
    if bn is not None:
        y = bn(y)
    if residual is not None:
        y = y + residual
    if relu:
        y = F.relu(y)
    if out_size is not None and tuple(y.shape[2:]) != tuple(out_size):
        y = y[:, :, :out_size[0], :out_size[1]]
    return y


def _pool_nhwc(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1).contiguous()


def _pool_nchw(x):
    return F.max_pool2d(x, 3, stride=2, padding=1)


class UNetResNet34(nn.Module):
    """Returns {'seg_logit': (B,H,W,num_classes), 'feature': (B,H,W,64)}."""

    fused_calls = 0  # forwards on the K5 path
    module_calls = 0  # forwards on the module path

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

    def fuses(self, image: torch.Tensor) -> bool:
        """Whether a forward of ``image`` takes the K5 path: eval mode,
        float32 throughout with cuDNN's TF32 off, and no gradient to record."""
        if self.training or image.dtype != torch.float32 or self.encoder0.compute_dtype != torch.float32:
            return False
        if torch.backends.cudnn.allow_tf32:
            return False
        if not torch.is_grad_enabled():
            return True
        return not (image.requires_grad or any(p.requires_grad for p in self.parameters()))

    def forward(self, image: torch.Tensor):
        if self.fuses(image):
            UNetResNet34.fused_calls += 1
            return self._forward_fused(image)
        UNetResNet34.module_calls += 1
        return self._forward_modules(image)

    def _walk(self, x, site, pool, h: int, w: int):
        """The UNet's sites in order, each ``site(conv, bn, x, ...)``: the
        stem on the image padded to a multiple of 16, the max-pool, the
        residual stages (their last three maps kept as skips beside the
        stem's), the decoder (a transposed conv, then a conv on it ⊕ the
        skip; the last one cropped to the image's h × w), the logit conv.
        Returns (feature, seg_logit)."""
        x = site(self.encoder0, self.bn0, x, out_size=(h + (-h) % 16, w + (-w) % 16))
        skips = [x]  # full res, 64ch
        x = pool(x)
        for stage, (_, depth) in enumerate(RESNET34_LAYERS):
            for i in range(depth):
                blk = getattr(self, f"layer{stage + 1}_{i}")
                y = site(blk.conv1, blk.bn1, x)
                residual = x if blk.proj is None else site(blk.proj, blk.proj_bn, x, relu=False)
                x = site(blk.conv2, blk.bn2, y, residual=residual)
            if stage < 3:
                skips.append(x)
        for stage in range(4):
            up = getattr(self, f"deconv{4 - stage}")
            x = site(up.deconv, up.bn, x)
            dec = getattr(self, f"decoder{3 - stage}")
            x = site(dec.conv, dec.bn, x, skip=skips[3 - stage], out_size=(h, w) if stage == 3 else None)
        return x, site(self.logit, None, x, relu=False)

    def _forward_fused(self, image: torch.Tensor):
        feature, seg_logit = self._walk(image.contiguous(), _site, _pool_nhwc, image.shape[1], image.shape[2])
        return {"seg_logit": seg_logit, "feature": feature}

    def _forward_modules(self, image: torch.Tensor):
        feature, seg_logit = self._walk(image.permute(0, 3, 1, 2), _module_site, _pool_nchw,
                                        image.shape[1], image.shape[2])
        return {"seg_logit": seg_logit.permute(0, 2, 3, 1), "feature": feature.permute(0, 2, 3, 1)}


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
