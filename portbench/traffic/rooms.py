"""Seeded RGB-D rooms: a frozen copy of the port's synthetic scene generator
(``mvkpconv_tpu_torch/data/synthetic.py``, the ``boxes`` family, and its
z-buffer renderer), kept here so that a change to the program cannot move
the benchmark's inputs.

A room is a floor, four walls and axis-aligned boxes ("furniture"), labelled
and coloured by class; cameras orbit the room and depth is rendered from the
cloud with a z-buffer, so depth, pose and intrinsics agree with the points.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# ScanNet's 20-class palette (mvpnet/utils/visualize.py:50)
PALETTE = np.asarray((
    (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
    (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
    (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
    (247, 182, 210), (219, 219, 141), (255, 127, 14), (158, 218, 229),
    (44, 160, 44), (112, 128, 144), (227, 119, 194), (82, 84, 163),
), np.float32) / 255.0
BOX_CLASSES = (2, 3, 4, 5, 6, 7, 19)


def _box_points(rng, center, size, per_face: int) -> np.ndarray:
    pts = []
    for axis in range(3):
        for side in (-0.5, 0.5):
            u = rng.rand(per_face) - 0.5
            v = rng.rand(per_face) - 0.5
            face = np.zeros((per_face, 3))
            face[:, axis] = side
            face[:, (axis + 1) % 3] = u
            face[:, (axis + 2) % 3] = v
            pts.append(face)
    return np.concatenate(pts) * np.asarray(size) + np.asarray(center)


def make_room(seed: int, num_points: int, room: Tuple[float, float, float],
              num_boxes: int) -> Dict[str, np.ndarray]:
    """points (N, 3) f32, colors (N, 3) f32 in [0, 1], labels (N,) int32 in
    [0, 20) or −1 (2% of the points, as raw ScanNet has unlabelled ones)."""
    rng = np.random.RandomState(seed)
    lx, ly, lz = room
    n_floor = num_points // 3
    n_wall = num_points // 3
    n_box = num_points - n_floor - n_wall
    floor = np.stack([rng.rand(n_floor) * lx, rng.rand(n_floor) * ly, np.zeros(n_floor)], 1)
    walls = []
    per_wall = n_wall // 4
    for i in range(4):
        u = rng.rand(per_wall)
        z = rng.rand(per_wall) * lz
        fixed = (np.zeros, lambda n: np.full(n, ly), np.zeros, lambda n: np.full(n, lx))[i](per_wall)
        if i < 2:
            walls.append(np.stack([u * lx, fixed, z], 1))
        else:
            walls.append(np.stack([fixed, u * ly, z], 1))
    walls = np.concatenate(walls)
    boxes, box_lab, box_col = [], [], []
    per_box = max(n_box // max(num_boxes, 1) // 6, 8)
    for cls in rng.choice(BOX_CLASSES, size=num_boxes):
        size = rng.uniform(0.4, 1.4, 3) * np.array([1, 1, 0.8])
        center = np.array([rng.uniform(1, lx - 1), rng.uniform(1, ly - 1), size[2] / 2])
        pts = _box_points(rng, center, size, per_box)
        boxes.append(pts)
        box_lab.append(np.full(len(pts), cls, np.int32))
        base = PALETTE[cls] + rng.normal(scale=0.05, size=3)
        box_col.append(np.tile(np.clip(base, 0, 1)[None], (len(pts), 1)))
    points = np.concatenate([floor, walls, *boxes]).astype(np.float32)
    colors = np.concatenate([
        np.tile([[0.6, 0.5, 0.4]], (n_floor, 1)), np.tile([[0.85, 0.85, 0.8]], (len(walls), 1)), *box_col,
    ]).astype(np.float32)
    labels = np.concatenate([
        np.full(n_floor, 1, np.int32), np.zeros(len(walls), np.int32), *box_lab,
    ]).astype(np.int32)
    points += rng.normal(scale=0.004, size=points.shape).astype(np.float32)
    labels[rng.rand(len(points)) < 0.02] = -1
    return {"points": points, "colors": colors, "labels": labels}


def intrinsics(h: int, w: int, fov_deg: float = 60.0) -> np.ndarray:
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def _look_at(eye, target, up=(0, 0, 1.0)) -> np.ndarray:
    """Camera-to-world pose, +z looking at the target."""
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, eye
    return pose


def render_views(room: Dict[str, np.ndarray], num_views: int, h: int, w: int, seed: int):
    """rgb (V, H, W, 3), depth (V, H, W) with 0 where no point projects,
    cam-to-world poses (V, 4, 4), intrinsics (V, 3, 3)."""
    rng = np.random.RandomState(seed + 1)
    pts, cols = room["points"], room["colors"]
    center = pts.mean(0)
    K = intrinsics(h, w)
    rgb = np.zeros((num_views, h, w, 3), np.float32)
    depth = np.zeros((num_views, h, w), np.float32)
    poses = np.zeros((num_views, 4, 4), np.float32)
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views + rng.uniform(-0.3, 0.3)
        eye = center + np.array([2.2 * np.cos(ang), 2.2 * np.sin(ang), rng.uniform(0.6, 1.4)])
        pose = _look_at(eye, center + rng.normal(scale=0.2, size=3))
        poses[v] = pose
        cam = (pts - pose[:3, 3]) @ pose[:3, :3]
        z = cam[:, 2]
        front = z > 0.05
        u = np.round(cam[:, 0] / z * K[0, 0] + K[0, 2]).astype(np.int64)
        vv = np.round(cam[:, 1] / z * K[1, 1] + K[1, 2]).astype(np.int64)
        ok = front & (u >= 0) & (u < w) & (vv >= 0) & (vv < h)
        flat = vv[ok] * w + u[ok]
        zo = z[ok]
        # z-buffer: the nearest point wins (descending depth, the last write wins)
        order = np.argsort(-zo, kind="stable")
        depth[v].reshape(-1)[flat[order]] = zo[order]
        rgb[v].reshape(-1, 3)[flat[order]] = cols[ok][order]
    return {"rgb": rgb, "depth": depth, "poses": poses,
            "intrinsics": np.tile(K[None], (num_views, 1, 1))}
