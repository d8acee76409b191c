"""The reference's 2D network: UNet on a ResNet34 encoder
(mvpnet/models/unet_resnet34.py), written with ``torch.nn.functional`` on a
flat dict of weights named as the port names them.

(N, H, W, 3) images are zero-padded at the bottom and right to a multiple of
16, run NCHW, and cropped back; the 64-wide feature map before the logit
convolution is the output. Batch norm is ``(x − mean)·(rsqrt(var + eps)·w) +
b`` with the given statistics (the frozen network's running ones, or the
batch's while calibrating).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

LAYERS = ((64, 3), (128, 4), (256, 6), (512, 3))
DECODER = ((256, 256), (128, 128), (64, 64), (64, 64))  # (filters, skip width) per stage


def spec(num_classes: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every tensor of the network, init one of
    ``conv`` (fan-in over the input channels and the window), ``deconv``
    (weight (in, out, kh, kw)), ``bn`` (weight, bias and running
    statistics) and ``bias``."""
    out = []

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", (cout, cin, k, k), "conv"))

    def bn(name, c):
        out.append((name, (c,), "bn"))

    conv("encoder0", 3, 64, 7)
    bn("bn0", 64)
    cin = 64
    for stage, (filters, depth) in enumerate(LAYERS):
        for i in range(depth):
            p = f"layer{stage + 1}_{i}"
            stride = 2 if (stage > 0 and i == 0) else 1
            conv(f"{p}.conv1", cin, filters, 3)
            bn(f"{p}.bn1", filters)
            conv(f"{p}.conv2", filters, filters, 3)
            bn(f"{p}.bn2", filters)
            if stride != 1 or cin != filters:
                conv(f"{p}.proj", cin, filters, 1)
                bn(f"{p}.proj_bn", filters)
            cin = filters
    for stage, (filters, skip) in enumerate(DECODER):
        out.append((f"deconv{4 - stage}.deconv.weight", (cin, filters, 2, 2), "deconv"))
        out.append((f"deconv{4 - stage}.deconv.bias", (filters,), "bias"))
        bn(f"deconv{4 - stage}.bn", filters)
        conv(f"decoder{3 - stage}.conv", filters + skip, filters, 3)
        bn(f"decoder{3 - stage}.bn", filters)
        cin = filters
    conv("logit", 64, num_classes, 1)
    out.append(("logit.bias", (num_classes,), "bias"))
    return out


def features(images: torch.Tensor, w: Dict[str, torch.Tensor], bn: Callable) -> torch.Tensor:
    """(N, H, W, 3) → (N, H, W, 64). ``bn(name, x)`` normalises x (NCHW) by
    the batch norm ``name``."""
    h, wd = images.shape[1], images.shape[2]
    x = F.pad(images.permute(0, 3, 1, 2), (0, (-wd) % 16, 0, (-h) % 16))
    x = F.relu(bn("bn0", F.conv2d(x, w["encoder0.weight"], padding=3)))
    skips = [x]
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    cin = 64
    for stage, (filters, depth) in enumerate(LAYERS):
        for i in range(depth):
            p = f"layer{stage + 1}_{i}"
            stride = 2 if (stage > 0 and i == 0) else 1
            y = F.relu(bn(f"{p}.bn1", F.conv2d(x, w[f"{p}.conv1.weight"], stride=stride, padding=1)))
            y = bn(f"{p}.bn2", F.conv2d(y, w[f"{p}.conv2.weight"], padding=1))
            if stride != 1 or cin != filters:
                x = bn(f"{p}.proj_bn", F.conv2d(x, w[f"{p}.proj.weight"], stride=stride))
            x = F.relu(y + x)
            cin = filters
        if stage < 3:
            skips.append(x)
    for stage in range(4):
        d = f"deconv{4 - stage}"
        x = F.conv_transpose2d(x, w[f"{d}.deconv.weight"], w[f"{d}.deconv.bias"], stride=2)
        x = F.relu(bn(f"{d}.bn", x))
        x = torch.cat([x, skips[3 - stage]], dim=1)
        c = f"decoder{3 - stage}"
        x = F.relu(bn(f"{c}.bn", F.conv2d(x, w[f"{c}.conv.weight"], padding=1)))
    return x[:, :, :h, :wd].permute(0, 2, 3, 1)
