"""Operations of an MVPNet step, counted from the configuration, whatever
implements them: the benchmark's counts for ``peak_seconds`` and for the
roofline of the farthest point sampling (``metrics/fps_roofline.mvpnet.py``).

Counted: the frozen UNet's convolutions over every view
(``portbench.counting.unet_flops``, at the size padded to a multiple of 16);
FeatureAggregation's and PointNet++'s dense layers, 2·Cin·Cout a row (a set
abstraction's rows are its centroids × 32 neighbours, a propagation's and
the head's the chunk's points); the 3-NN interpolation's weighted sums,
2·C a neighbour of each dense point; and the farthest point sampling at
9 operations a point a step (the difference form's three subtractions,
three products and two sums, and the minimum with the running one), a
step for each centroid, at the float32 peak. Batch norm, activations, the
max, gathers, the ball query's and the 3-NN's distances are left out, so
the counts are a lower bound of the work. A trained layer's backward counts
twice its forward; the frozen UNet and the sampling run forward only.
"""

from __future__ import annotations

from typing import Dict

from portbench.counting import PEAK_F32, PEAK_TF32, unet_flops
from portbench.reference_mvpnet.model import widths

FPS_OPS = 9  # operations a point a step of the farthest point sampling


def level_points(model: Dict, n: int):
    """Points of each level of a chunk of ``n``: the chunk's, then each set
    abstraction's centroids."""
    return [n] + list(model["num_centroids"])


def fps_ops(model: Dict, b: int, n: int) -> float:
    """Operations of the farthest point samplings, all four levels, of ``b``
    chunks of ``n`` points."""
    pts = level_points(model, n)
    return float(b * sum(FPS_OPS * p * m for p, m in zip(pts[:-1], pts[1:])))


def fps_seconds(model: Dict) -> float:
    """The least time of one batch's farthest point samplings at the float32
    peak (they are no matrix product), at the configuration's sizes."""
    return fps_ops(model, model["batch_num"], model["chunk_points"]) / PEAK_F32


def forward_flops(model: Dict, b: int, n: int) -> Dict[str, float]:
    """{'unet': the frozen UNet's, 'trained': the trained layers'} FLOPs of
    one forward of ``b`` chunks of ``n`` points."""
    pts = level_points(model, n)
    rows = b * pts[0] * model["pixel_knn"]
    trained = 0.0
    cin = model["feature_2d_dim"] + 4
    for c in model["aggregation_channels"]:
        trained += 2 * rows * cin * c
        cin = c
    sa_in, fp_in = widths(model)
    for i, (cin, channels) in enumerate(zip(sa_in, model["sa_channels"])):
        rows = b * pts[i + 1] * model["max_neighbors"]
        for c in channels:
            trained += 2 * rows * cin * c
            cin = c
    for i, (cin, channels) in enumerate(zip(fp_in, model["fp_channels"])):
        rows = b * pts[-2 - i]
        sparse = model["fp_channels"][i - 1][-1] if i else model["sa_channels"][-1][-1]
        trained += 2 * rows * 3 * sparse
        for c in channels:
            trained += 2 * rows * cin * c
            cin = c
    for c in model["seg_channels"] + [model["num_classes"]]:
        trained += 2 * b * pts[0] * cin * c
        cin = c
    unet = float(b * model["num_views"] * unet_flops(model["image_height"], model["image_width"],
                                                         model["num_classes"]))
    return {"unet": unet, "trained": float(trained)}


def peak_seconds(model: Dict, batch, train: bool, tf32: Dict[str, bool]) -> float:
    """The least time of one step at the published peaks, each class of
    operations at its precision's (``tf32``: the switches ``{"matmul":
    bool, "cudnn": bool}`` the step ran under), from the batch's chunks
    and their points (every one real)."""
    b, n, _ = batch["points"].shape
    f = forward_flops(model, b, n)
    unet = PEAK_TF32 if tf32["cudnn"] else PEAK_F32
    rest = PEAK_TF32 if tf32["matmul"] else PEAK_F32
    return f["unet"] / unet + (3 if train else 1) * f["trained"] / rest + fps_ops(model, b, n) / PEAK_F32
