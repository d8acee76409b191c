"""Whole-scene 2D→3D feature precompute (``mvkpconv_tpu/eval/precompute.py``).

The reference's offline feature route (mvpnet/models/mvpnet_3d.py:231-279
``get_2d3dfeature`` over ``ScanNet2D3DWhole``): the frozen UNet over all of
a scene's frames once, then, a fixed-size point chunk at a time, the
projective pixel k-NN (kernel K2), the gathers of pixel features and
positions, and FeatureAggregation. The result, an (N, feature_2d_dim)
array a scene, goes on the scene dict as ``feature_2d3d``: SphereDataset
slices it per sphere and ``MVKPConv`` takes it in place of its in-graph
lift.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from mvkpconv_tpu_torch.data.spheres import grid_subsample_np
from mvkpconv_tpu_torch.models.feature_aggregation import FeatureAggregation
from mvkpconv_tpu_torch.models.unet2d import UNetResNet34
from mvkpconv_tpu_torch.ops.gather import group_points
from mvkpconv_tpu_torch.ops.unproject import points_to_pixel_knn_projective, unproject_depth

POINT_CHUNK = 4096  # points a lift, as the JAX package's precompute takes them


@torch.inference_mode()
def precompute_scene_2d3d_features(
    scene: Dict[str, np.ndarray], cfg, unet: UNetResNet34, fa: FeatureAggregation
) -> np.ndarray:
    """(N, feature_2d_dim) lifted 2D features for every point of ``scene``
    (points (N, 3) and rgb / depth / intrinsics / poses over ALL its
    frames), on the device ``unet`` lies on; ``unet`` and ``fa`` run in eval
    mode. The last chunk is padded with points at the origin, whose rows
    are dropped."""
    device = next(unet.parameters()).device
    unet.eval()
    fa.eval()
    images = torch.tensor(scene["rgb"], dtype=torch.float32, device=device)  # (F, H, W, 3)
    f, h, w, _ = images.shape
    feat_flat = unet(images)["feature"].reshape(1, f * h * w, -1)
    intr = torch.tensor(scene["intrinsics"], dtype=torch.float32, device=device)[None]
    poses = torch.tensor(scene["poses"], dtype=torch.float32, device=device)[None]
    depth = torch.tensor(scene["depth"], dtype=torch.float32, device=device)[None]
    image_xyz, _ = unproject_depth(depth, intr, poses)
    xyz_flat = image_xyz.reshape(1, f * h * w, 3)

    points = np.asarray(scene["points"], np.float32)
    n = len(points)
    out = np.zeros((n, cfg.feature_2d_dim), np.float32)
    for start in range(0, n, POINT_CHUNK):
        chunk = points[start:start + POINT_CHUNK]
        real = len(chunk)
        chunk = np.pad(chunk, ((0, POINT_CHUNK - real), (0, 0)))
        pts = torch.tensor(chunk, device=device)[None]
        knn_idx = points_to_pixel_knn_projective(
            pts, image_xyz, intr, poses, cfg.pixel_knn, window=cfg.pixel_window)
        got = fa(group_points(xyz_flat, knn_idx), pts, group_points(feat_flat, knn_idx))
        out[start:start + real] = got[0, :real].float().cpu().numpy()
    return out


def attach_precomputed_features(
    scenes: Sequence[Dict[str, np.ndarray]], cfg, unet: UNetResNet34, fa: FeatureAggregation
) -> list:
    """Subsample each scene at ``first_subsampling_dl`` and attach
    ``feature_2d3d`` computed on the subsampled points (the coordinates the
    sphere sampler indexes); the raw frames go (the precomputed route no
    longer needs them, the point of the reference's offline cache). Feed
    the result to ``SphereDataset(..., subsample=False)``."""
    out = []
    for scene in scenes:
        pts, cols, lab = grid_subsample_np(
            scene["points"], scene["colors"], scene["labels"],
            cfg.first_subsampling_dl, cfg.num_classes,
        )
        sub = dict(scene, points=pts, colors=cols, labels=lab)
        sub["feature_2d3d"] = precompute_scene_2d3d_features(sub, cfg, unet, fa)
        for k in ("rgb", "depth", "poses", "intrinsics"):
            sub.pop(k, None)
        out.append(sub)
    return out
