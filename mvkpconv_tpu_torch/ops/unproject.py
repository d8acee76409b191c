"""Depth unprojection and projective 2D→3D pixel association
(``mvkpconv_tpu/ops/unproject.py``).

Conventions: depth (B, V, H, W) float32 metres, 0 = invalid; intrinsics
(B, V, 3, 3); cam-to-world poses (B, V, 4, 4). Invalid pixels are placed at
``SHADOW_COORD`` so neighbor searches ignore them. The 3×3 rotations are
written out as sums of products, so the card and the CPU compute the same
f32 values (no TF32 in a matmul).

The TPU package feeds its pixel-selection kernel im2col candidate rows
(``pallas_candidate_rows``), a workaround for TPU gathers; the port's kernel
K2 reads the windows straight from ``image_xyz``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvkpconv_tpu_torch.ops.common import SHADOW_COORD
from mvkpconv_tpu_torch.ops.kernels.pixel_select import pixel_topk
from mvkpconv_tpu_torch.ops.neighbors import knn


def unproject_depth(
    depth: torch.Tensor, intrinsics: torch.Tensor, poses: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unproject depth maps to world coordinates.

    Returns (image_xyz (B, V, H, W, 3) with invalid pixels at SHADOW_COORD,
    valid (B, V, H, W) bool).
    """
    b, v, h, w = depth.shape
    us = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    vs = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    z = depth
    x = (us - cx) * z / fx
    y = (vs - cy) * z / fy
    rot = poses[..., :3, :3][:, :, None, None]  # (B, V, 1, 1, 3, 3)
    trans = poses[..., :3, 3][:, :, None, None, :]
    world = (
        rot[..., 0] * x[..., None] + rot[..., 1] * y[..., None]
    ) + rot[..., 2] * z[..., None]
    world = world + trans
    valid = depth > 0
    world = torch.where(valid[..., None], world, torch.full_like(world, SHADOW_COORD))
    return world, valid


def points_to_pixel_knn(points: torch.Tensor, image_xyz: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Brute-force k-NN of (B, N, 3) points in the flattened (B, V·H·W)
    pixel cloud of (B, V, H, W, 3) ``image_xyz`` (invalid pixels at
    SHADOW_COORD): the global nearest pixels, for batches without poses.

    Returns (B, N, k) int32 indices into the V·H·W axis, ascending by d²
    (JAX ``points_to_pixel_knn(method='exact')``).
    """
    b = image_xyz.shape[0]
    return knn(points, image_xyz.reshape(b, -1, 3), k)[0]


def project_to_views(
    points: torch.Tensor, intrinsics: torch.Tensor, poses: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole projection of (B, N, 3) world points into every view.

    Returns (u, v) pixel coordinates, each (B, V, N) float32.
    """
    rot = poses[..., :3, :3][:, :, None]  # (B, V, 1, 3, 3) cam-to-world
    trans = poses[..., :3, 3]
    rel = points[:, None, :, :] - trans[:, :, None, :]  # (B, V, N, 3)
    # world → camera: X_cam = Rᵀ (X_w − t), cam_j = Σ_i R_ij rel_i
    cam = (
        rot[..., 0, :] * rel[..., 0:1] + rot[..., 1, :] * rel[..., 1:2]
    ) + rot[..., 2, :] * rel[..., 2:3]
    z = cam[..., 2].clamp(min=1e-3)
    fx = intrinsics[..., 0, 0][..., None]
    fy = intrinsics[..., 1, 1][..., None]
    cx = intrinsics[..., 0, 2][..., None]
    cy = intrinsics[..., 1, 2][..., None]
    u = cam[..., 0] / z * fx + cx
    v = cam[..., 1] / z * fy + cy
    return u, v


def window_anchors(u: torch.Tensor, size: int, window: int) -> torch.Tensor:
    """Window start corner: round half to even, minus window // 2, clipped to
    [0, size - window] (unproject.py:233-234). Values are bounded in float
    before the int cast so far-off projections of padded points stay
    defined; that bound lies outside [0, size] and changes no anchor."""
    r = torch.round(u).clamp(-(2.0**30), 2.0**30).to(torch.int32)
    return (r - window // 2).clamp(0, size - window)


def points_to_pixel_knn_projective(
    points: torch.Tensor,
    image_xyz: torch.Tensor,
    intrinsics: torch.Tensor,
    poses: torch.Tensor,
    k: int = 3,
    window: int = 9,
    patch_dtype=None,
) -> torch.Tensor:
    """Pixel association via camera projection — O(V·window²) per point.

    Each point's candidates are the window² pixels around its projection in
    every view; K2 selects the k nearest in 3D (exact, ties to the lower
    view-major slot). ``patch_dtype`` rounds the candidate positions before
    the selection (bf16 halves the bytes read); the points stay f32.

    Returns (B, N, min(k, V·window²)) int32 indices into the flat V·H·W axis.
    """
    b, v, h, w, _ = image_xyz.shape
    u, vv = project_to_views(points, intrinsics, poses)
    iu0 = window_anchors(u, w, window).contiguous()
    iv0 = window_anchors(vv, h, window).contiguous()
    img = image_xyz if patch_dtype is None else image_xyz.to(patch_dtype)
    return pixel_topk(
        points.float().contiguous(), img.contiguous(), iu0, iv0, window,
        min(k, v * window * window),
    )
