"""Operations and bytes of a step, counted from the configuration and from
what the batch's geometry needs, whatever implements it.

Sources: the KPConv operator (Thomas et al., ICCV 2019, eq. 1–3): for each
query, the influence-weighted sum over its neighbors in the radius (up to
the neighbor limit) for each of the M kernel points, then one (M·Cin) ×
Cout product; the UNet-ResNet34's convolutions at the padded image size it
runs at; a dense layer 2·Cin·Cout a row. Only real points, their real
neighbors and real pixel rows count; batch norm, activations, gathers and
the influence (computed once a level) are left out, so the counts are a
lower bound of the work. A trained layer's backward counts twice its
forward (the input's and the weights' gradients); the frozen UNet runs
forward only.

Published peaks of one H100 SXM (NVIDIA's data sheet, dense): 495 TFLOP/s
TF32 on the tensor cores, 67 TFLOP/s float32 outside them. Each class of
operations is held to the peak of the precision it runs at: the UNet's
cuDNN convolutions at TF32 where ``torch.backends.cudnn.allow_tf32`` lets
them, the rest (matrix products and sums) at TF32 where
``torch.backends.cuda.matmul.allow_tf32`` does, else each at float32.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from portbench.reference import unet
from portbench.reference.geometry import build_pyramid
from portbench.reference.model import trunk

PEAK_TF32 = 495e12
PEAK_F32 = 67e12


class LevelStats(NamedTuple):
    points: int  # real points of the level
    conv_pairs: int  # real (query, neighbor) pairs of its conv neighbors
    pool_pairs: int  # real pairs from the next level's points into this one
    up_pairs: int  # points of this level with a real upsample neighbor


def pyramid_stats(batch: Dict[str, torch.Tensor], model: Dict) -> List[LevelStats]:
    """Per level of the batch's pyramid (the reference's, on the batch's
    device)."""
    lengths = [int(n) for n in batch["mask"].sum(1).tolist()]
    pyr = build_pyramid([batch["points"][i, :n] for i, n in enumerate(lengths)], model)

    def real(idx, n_support):
        return 0 if idx is None else int((idx < n_support).sum())

    out = []
    for lv, level in enumerate(pyr):
        n = len(level.points)
        nxt = len(pyr[lv + 1].points) if lv + 1 < len(pyr) else 0
        out.append(LevelStats(n, real(level.conv, n), real(level.pool, n), real(level.up, nxt)))
    return out


def unet_flops(h: int, w: int, num_classes: int) -> int:
    """Multiply-adds ×2 of one image through the UNet, at the size padded to
    a multiple of 16 (the logit convolution at the image's own size, after
    the crop)."""
    logit = 2 * 64 * num_classes * h * w
    h, w = h + (-h) % 16, w + (-w) % 16
    total = 0

    def conv(cin, cout, k, hw):
        return 2 * cin * cout * k * k * hw[0] * hw[1]

    total += conv(3, 64, 7, (h, w))
    size = (h // 2, w // 2)
    cin = 64
    for stage, (filters, depth) in enumerate(unet.LAYERS):
        for i in range(depth):
            if stage > 0 and i == 0:
                size = (size[0] // 2, size[1] // 2)
                total += conv(cin, filters, 1, size)  # the projection shortcut
            total += conv(cin, filters, 3, size) + conv(filters, filters, 3, size)
            cin = filters
    for filters, skip in unet.DECODER:
        total += 2 * cin * filters * 2 * 2 * size[0] * size[1]  # 2×2 stride-2 transposed conv
        size = (size[0] * 2, size[1] * 2)
        total += conv(filters + skip, filters, 3, size)
        cin = filters
    return total + logit


def _conv_sites(model: Dict):
    """(prefix, block, in, out, level) of every block of the trunk."""
    encoders, dec, _ = trunk(model)
    rows = [(name, blk, cin, cout, lv) for name, enc in encoders.items() for blk, cin, cout, _r, lv in enc]
    return rows + [("decoder", blk, cin, cout, lv) for blk, cin, cout, _r, lv, _c in dec]


def forward_flops(model: Dict, stats: List[LevelStats]) -> Dict[str, float]:
    """{'unet': the frozen UNet's, 'trained': the trained layers'} FLOPs of
    one forward of the batch."""
    m = model["num_kernel_points"]
    trained = 0.0
    for _name, blk, cin, cout, lv in _conv_sites(model):
        q = stats[lv + 1].points if "strided" in blk else stats[lv].points
        pairs = stats[lv].pool_pairs if "strided" in blk else stats[lv].conv_pairs
        if blk == "unary":
            trained += 2 * stats[lv].points * cin * cout
        elif blk == "simple":
            trained += 2 * pairs * m * cin + 2 * q * m * cin * (cout // 2)
        elif "resnetb" in blk:
            mid = cout // 4
            if cin != mid:
                trained += 2 * stats[lv].points * cin * mid
            trained += 2 * pairs * m * mid + 2 * q * m * mid * mid + 2 * q * mid * cout
            if cin != cout:
                trained += 2 * q * cin * cout
    f, c = model["first_features_dim"], model["num_classes"]
    head_in = trunk(model)[2] + (0 if model["fusion"] != "late" else model["feature_2d_dim"])
    trained += 2 * stats[0].points * (head_in * f + f * c)
    out = {"unet": 0.0, "trained": trained}
    if model["fusion"] != "none":
        rows = stats[0].points * model["pixel_knn"]
        out["trained"] += 2 * rows * ((model["feature_2d_dim"] + 4) * 64 + 64 * 64 + 64 * 64)
        out["unet"] = float(model["batch_num"] * model["num_views"]
                            * unet_flops(model["image_height"], model["image_width"], model["num_classes"]))
    return out


def step_seconds_at_peak(model: Dict, stats: List[LevelStats], train: bool, tf32: Dict[str, bool]) -> float:
    """The least time a step could take on the card at the published peaks,
    each class of operations at its precision's (``tf32``: the switches
    ``{"matmul": bool, "cudnn": bool}`` the step ran under)."""
    f = forward_flops(model, stats)
    unet = PEAK_TF32 if tf32["cudnn"] else PEAK_F32
    rest = PEAK_TF32 if tf32["matmul"] else PEAK_F32
    return f["unet"] / unet + (3 if train else 1) * f["trained"] / rest
