"""Point sampling (``mvkpconv_tpu/ops/sampling.py``): farthest point
sampling and voxel-grid subsampling.

``farthest_point_sample`` is the JAX package's iterative FPS, one step a
centroid in eager PyTorch (ROADMAP queue 2 has its time on the card).

``grid_subsample``: static-shape barycenter subsampling: voxels are emitted in ascending
voxel-id order into a fixed ``max_out`` buffer with a validity mask;
overflow beyond ``max_out`` is dropped and reported via ``num_valid``.
The voxel id is ``(x << 20) | (y << 10) | z`` relative to the floor of the
valid points' min corner, each axis clipped to 1024 cells, and the sort is
stable (as ``jnp.argsort`` is), so the output order matches the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mvkpconv_tpu_torch.ops.common import masked_points


class GridSubsampleResult(NamedTuple):
    points: torch.Tensor  # (B, max_out, 3), invalid slots at SHADOW_COORD
    mask: torch.Tensor  # (B, max_out) bool
    num_valid: torch.Tensor  # (B,) int32 — voxel count BEFORE the cap


def grid_subsample(
    points: torch.Tensor,
    cell_size: float,
    max_out: int,
    mask: Optional[torch.Tensor] = None,
) -> GridSubsampleResult:
    """Per-voxel barycenters of (B, N, 3) or (N, 3) points.

    Labels and features (majority vote / voxel mean) are not ported yet;
    the inference pyramid needs neither.
    """
    if points.dim() == 2:
        out = grid_subsample(
            points[None], cell_size, max_out,
            None if mask is None else mask[None],
        )
        return GridSubsampleResult(out.points[0], out.mask[0], out.num_valid[0])
    b, n, _ = points.shape
    dev = points.device
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    inv_cell = torch.tensor(1.0 / cell_size, dtype=torch.float32, device=dev)
    big = torch.where(mask[..., None], points, torch.full_like(points, float("inf")))
    origin = torch.floor(big.amin(dim=1) * inv_cell).to(torch.int32)  # (B, 3)
    vox = torch.floor(points * inv_cell).to(torch.int32) - origin[:, None, :]
    vox = vox.clamp(0, 2**10 - 1)  # 3 x 10 bits: the id fits int32
    vid = (vox[..., 0] << 20) | (vox[..., 1] << 10) | vox[..., 2]
    vid = torch.where(mask, vid, torch.full_like(vid, 2**30))  # invalid last

    order = torch.argsort(vid, dim=1, stable=True)
    vid_s = torch.gather(vid, 1, order)
    valid_s = torch.gather(mask, 1, order)
    new_seg = torch.ones_like(vid_s)
    new_seg[:, 1:] = (vid_s[:, 1:] != vid_s[:, :-1]).to(vid_s.dtype)
    seg = torch.cumsum(new_seg, dim=1) - 1  # segment id in voxel-id order
    last = torch.where(valid_s, seg, torch.full_like(seg, -1)).amax(dim=1)
    num_valid = (last + 1).to(torch.int32)  # 0 when no point is valid
    # invalid points and overflow voxels route to the trash segment max_out
    keep = valid_s & (seg < max_out)
    seg = torch.where(keep, seg, torch.full_like(seg, max_out)).long()

    ones = keep.to(torch.float32)
    counts = torch.zeros((b, max_out + 1), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, seg, ones)
    pts_s = torch.gather(points, 1, order[..., None].expand(b, n, 3))
    psum = torch.zeros((b, max_out + 1, 3), dtype=torch.float32, device=dev)
    psum.scatter_add_(1, seg[..., None].expand(b, n, 3), pts_s * ones[..., None])
    counts, psum = counts[:, :-1], psum[:, :-1]
    out_mask = counts > 0
    out_points = masked_points(psum / counts.clamp(min=1.0)[..., None], out_mask)
    return GridSubsampleResult(out_points, out_mask, num_valid)


def farthest_point_sample(
    points: torch.Tensor, num_samples: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Iterative farthest point sampling of (B, N, 3) points → (B,
    num_samples) int32 centroid indices.

    The first centroid is index 0; each next one maximizes the distance to
    the chosen set, ties to the lowest index (``argmax``); points with a
    False ``mask`` are never picked. With ``num_samples > N`` every point is
    taken once, then every distance is 0 and index 0 repeats, as in the JAX
    package. d² is ((dx² + dy²) + dz²), each step rounded.
    """
    b, n, _ = points.shape
    p = points.float()
    out = torch.zeros((b, num_samples), dtype=torch.int64, device=points.device)
    min_d2 = torch.full((b, n), float("inf"), device=points.device)
    cur = torch.zeros((b, 1), dtype=torch.int64, device=points.device)
    for i in range(1, num_samples):
        diff = p - torch.gather(p, 1, cur[..., None].expand(b, 1, 3))
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        cand = min_d2 if mask is None else min_d2.masked_fill(~mask, float("-inf"))
        cur = cand.argmax(dim=1, keepdim=True)
        out[:, i:i + 1] = cur
    return out.to(torch.int32)
