"""The reference's geometry: the input pyramid and the 2D→3D pixel
association, one sphere at a time on its real points only, stacked as
KPConv-PyTorch stacks its batches (no padded slot anywhere).

Arithmetic that decides a discrete choice is written out as the
configuration defines it, so that the reference and the program choose
alike where the inputs are the same bits: squared distances in the
difference form ((dx² + dy²) + dz², f32, each step rounded), the radius
squared as the f32 square of the f32 radius, ties broken by the lower index;
the unprojection and the projection as sums of f32 products in the
published order. Voxel barycenters are summed in float64.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

SHADOW_COORD = 1.0e6
_INF_KEY = 0x7F800000 << 32  # the key of a pair outside the radius


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) × (..., 3) → the f32 difference-form squared distance."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def radius_search(query: torch.Tensor, support: torch.Tensor, radius: float, k: int,
                  pairs: int = 1 << 24) -> torch.Tensor:
    """Up to ``k`` supports with d² < r² of each query, ascending by (d²,
    index); (Nq, k) int64, ``len(support)`` where a slot is empty."""
    r = np.float32(radius)
    r2 = torch.tensor(float(r * r), dtype=torch.float32, device=query.device)
    ns = len(support)
    keff = min(k, ns)
    idx = torch.arange(ns, dtype=torch.int64, device=query.device)
    out = []
    step = max(1, pairs // max(ns, 1))
    for s in range(0, len(query), step):
        d2 = sq_dist(query[s:s + step, None, :], support[None, :, :])
        key = (d2.view(torch.int32).to(torch.int64) << 32) | idx
        key = torch.where(d2 < r2, key, torch.full_like(key, _INF_KEY))
        top = torch.topk(key, keff, dim=1, largest=False, sorted=True).values
        out.append(torch.where(top < _INF_KEY, top & 0xFFFFFFFF, torch.full_like(top, ns)))
    got = torch.cat(out) if out else torch.zeros((0, keff), dtype=torch.int64, device=query.device)
    if keff < k:
        got = torch.cat([got, got.new_full((len(query), k - keff), ns)], 1)
    return got


def grid_subsample(points: torch.Tensor, cell: float, max_out: int) -> torch.Tensor:
    """Voxel barycenters of (n, 3) real points in ascending voxel-id order
    (id = x·2²⁰ + y·2¹⁰ + z over the voxel grid from the points' floor
    corner, each axis clipped to 1,024 cells), the first ``max_out`` kept."""
    inv = torch.tensor(1.0 / cell, dtype=torch.float32, device=points.device)
    origin = torch.floor(points.amin(0) * inv).to(torch.int32)
    vox = (torch.floor(points * inv).to(torch.int32) - origin).clamp(0, 1023).to(torch.int64)
    vid = (vox[:, 0] << 20) | (vox[:, 1] << 10) | vox[:, 2]
    uniq, inverse = torch.unique(vid, sorted=True, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=torch.float64, device=points.device)
    sums.index_add_(0, inverse, points.double())
    counts = torch.bincount(inverse, minlength=len(uniq)).double()
    return (sums / counts[:, None]).float()[:max_out]


class Level(NamedTuple):
    points: torch.Tensor  # (N_l, 3) stacked real points
    lengths: List[int]  # per sphere
    conv: torch.Tensor  # (N_l, K) into this level, N_l where empty
    pool: torch.Tensor  # (N_{l+1}, K) into this level (not on the last level)
    up: torch.Tensor  # (N_l, 1) into level l+1 (not on the last level)


def build_pyramid(spheres: List[torch.Tensor], model: Dict) -> List[Level]:
    """The pyramid of a batch given as a list of each sphere's real level-0
    points: per level the conv neighbors within dl·2^l·conv_radius, and
    between levels the grid subsample, the pool neighbors (queries one level
    up, the same radius) and the upsample 1-NN (within twice that radius)."""
    dl, cr = model["first_subsampling_dl"], model["conv_radius"]
    levels = len(model["num_points"])
    per = [list(spheres)]
    for lvl in range(1, levels):
        cell = dl * 2.0 ** lvl
        per.append([grid_subsample(p, cell, model["num_points"][lvl]) for p in per[-1]])
    out = []
    for lvl in range(levels):
        r = dl * 2.0 ** lvl * cr
        lengths = [len(p) for p in per[lvl]]
        offs = np.cumsum([0] + lengths)
        total = int(offs[-1])

        def stack(lists, sup_offs, sup_total):
            rows = []
            for b, t in enumerate(lists):
                rows.append(torch.where(t < sup_offs[b + 1] - sup_offs[b], t + int(sup_offs[b]),
                                        torch.full_like(t, sup_total)))
            return torch.cat(rows)

        conv = stack([radius_search(p, p, r, model["conv_neighbors"][lvl]) for p in per[lvl]], offs, total)
        pool = up = None
        if lvl + 1 < levels:
            nxt = per[lvl + 1]
            noffs = np.cumsum([0] + [len(p) for p in nxt])
            pool = stack([radius_search(q, p, r, model["pool_neighbors"][lvl]) for q, p in zip(nxt, per[lvl])],
                         offs, total)
            up = stack([radius_search(p, q, 2.0 * r, 1) for p, q in zip(per[lvl], nxt)], noffs, int(noffs[-1]))
        out.append(Level(torch.cat(per[lvl]), lengths, conv, pool, up))
    return out


def unproject(depth, intrinsics, poses) -> torch.Tensor:
    """(B, V, H, W, 3) world positions of every pixel, SHADOW_COORD where the
    depth is 0: x = (u − cx)·z/fx, y = (v − cy)·z/fy, then R·(x, y, z) + t as
    the sum of R's columns times x, y, z."""
    b, v, h, w = depth.shape
    us = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    vs = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    fx, fy = intrinsics[..., 0, 0][..., None, None], intrinsics[..., 1, 1][..., None, None]
    cx, cy = intrinsics[..., 0, 2][..., None, None], intrinsics[..., 1, 2][..., None, None]
    z = depth
    x = (us - cx) * z / fx
    y = (vs - cy) * z / fy
    rot = poses[..., :3, :3][:, :, None, None]
    world = (rot[..., 0] * x[..., None] + rot[..., 1] * y[..., None]) + rot[..., 2] * z[..., None]
    world = world + poses[..., :3, 3][:, :, None, None, :]
    return torch.where((depth > 0)[..., None], world, torch.full_like(world, SHADOW_COORD))


def pixel_neighbors(points: torch.Tensor, image_xyz: torch.Tensor, intrinsics, poses,
                    k: int, window: int) -> torch.Tensor:
    """The ``k`` pixels nearest in 3D to each of a sphere's (n, 3) points
    among the window×window pixels around its projection in each of its
    (V, H, W, 3) views, ties to the lower slot (view-major, then row-major in
    the window); (n, k) flat indices into the V·H·W pixels."""
    v, h, w, _ = image_xyz.shape
    rot, trans = poses[:, :3, :3], poses[:, :3, 3]
    rel = points[None] - trans[:, None, :]  # (V, n, 3)
    r = rot[:, None]  # (V, 1, 3, 3): world → camera is Rᵀ
    cam = (r[..., 0, :] * rel[..., 0:1] + r[..., 1, :] * rel[..., 1:2]) + r[..., 2, :] * rel[..., 2:3]
    z = cam[..., 2].clamp(min=1e-3)
    u = cam[..., 0] / z * intrinsics[:, 0, 0, None] + intrinsics[:, 0, 2, None]
    vv = cam[..., 1] / z * intrinsics[:, 1, 1, None] + intrinsics[:, 1, 2, None]

    def anchor(c, size):  # round half to even, then the window's corner, clipped
        return (torch.round(c).clamp(-(2.0**30), 2.0**30).to(torch.int64) - window // 2).clamp(0, size - window)

    iu0, iv0 = anchor(u, w), anchor(vv, h)  # (V, n)
    ar = torch.arange(window * window, device=points.device)
    dv, du = ar // window, ar % window
    flat = ((iv0[..., None] + dv) * w + (iu0[..., None] + du)
            + (torch.arange(v, device=points.device) * (h * w))[:, None, None])  # (V, n, w²)
    flat = flat.permute(1, 0, 2).reshape(len(points), -1)  # slot order: view-major
    cand = image_xyz.reshape(-1, 3)[flat]
    d2 = sq_dist(cand, points[:, None, :])
    slot = torch.arange(flat.shape[1], dtype=torch.int64, device=points.device)
    key = (d2.view(torch.int32).to(torch.int64) << 32) | slot
    pick = torch.topk(key, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
    return torch.gather(flat, 1, pick)
