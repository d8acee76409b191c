"""Synthetic RGB-D indoor scenes for tests, benchmarks and pipeline bring-up:
a copy of ``mvkpconv_tpu/data/synthetic.py`` (``tests/test_torch_data.py``
pins it: the same seed gives equal arrays).

The reference has no synthetic data path (its smoke tests need real ScanNet
on disk); we add one so every subsystem — sphere sampling, multi-view
rendering geometry, fusion models, voting evaluation — can be exercised
end-to-end hermetically. Scenes are room-like: floor + walls + randomly
placed boxes ("furniture"), with class labels and colors correlated to
geometry so models can actually learn. Cameras orbit the room; depth maps
are rendered from the point cloud with a z-buffer (scatter-min), giving
geometrically consistent depth/pose/intrinsics for the unprojection path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _box_points(rng, center, size, points_per_face: int) -> np.ndarray:
    pts = []
    for axis in range(3):
        for side in (-0.5, 0.5):
            u = rng.rand(points_per_face) - 0.5
            v = rng.rand(points_per_face) - 0.5
            face = np.zeros((points_per_face, 3))
            face[:, axis] = side
            face[:, (axis + 1) % 3] = u
            face[:, (axis + 2) % 3] = v
            pts.append(face)
    pts = np.concatenate(pts) * np.asarray(size)
    return pts + np.asarray(center)


def _rotation(rng, max_tilt: float) -> np.ndarray:
    """Random yaw + bounded tilt — non-axis-aligned object poses."""
    yaw = rng.uniform(0, 2 * np.pi)
    cz, sz = np.cos(yaw), np.sin(yaw)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    tilt = rng.uniform(-max_tilt, max_tilt)
    ct, st = np.cos(tilt), np.sin(tilt)
    rx = np.array([[1.0, 0, 0], [0, ct, -st], [0, st, ct]])
    return rz @ rx


def _cylinder_points(rng, radius, height, n) -> np.ndarray:
    """Lateral shell of a cylinder along +z, centered at origin."""
    theta = rng.uniform(0, 2 * np.pi, n)
    z = (rng.rand(n) - 0.5) * height
    return np.stack(
        [radius * np.cos(theta), radius * np.sin(theta), z], 1
    )


def _sphere_shell_points(rng, radius, n) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    return v * radius


def _arch_points(rng, major, minor, n) -> np.ndarray:
    """Half-torus arch in the xz plane (feet on z=0, crown at z=major)."""
    phi = rng.uniform(0, np.pi, n)  # sweep: foot → crown → foot
    psi = rng.uniform(0, 2 * np.pi, n)  # tube angle
    ring = major + minor * np.cos(psi)
    return np.stack(
        [ring * np.cos(phi), minor * np.sin(psi), ring * np.sin(phi)], 1
    )


def make_scene(
    seed: int = 0,
    num_points: int = 60000,
    room: Tuple[float, float, float] = (6.0, 5.0, 2.6),
    num_boxes: int = 6,
    family: str = "boxes",
) -> Dict[str, np.ndarray]:
    """Build a labeled room point cloud.

    ``family`` selects the furniture geometry:
      'boxes'  — axis-aligned planar boxes (the round-1 default; planes
                 only, the regime where rigid KPConv grids already align).
      'curved' — cylinders / spherical shells / half-torus arches /
                 tilted cylinders, with class identity carried by the
                 curvature profile. This is the regime the reference
                 claims deformable kernels for (KPConv paper §5;
                 KPConv-PyTorch/models/blocks.py:237-325): thin shells
                 whose curvature radius is comparable to the kernel
                 extent, where a rigid kernel ball mostly samples empty
                 space and an offset-adapted one conforms to the surface.

    Returns dict(points (N,3) float32, colors (N,3) float32 in [0,1],
    labels (N,) int32 in [0,20)).
    """
    if family not in ("boxes", "curved"):
        raise ValueError(f"unknown scene family {family!r}")
    rng = np.random.RandomState(seed)
    lx, ly, lz = room
    n_floor = num_points // 3
    n_wall = num_points // 3
    n_box = num_points - n_floor - n_wall

    floor = np.stack(
        [rng.rand(n_floor) * lx, rng.rand(n_floor) * ly, np.zeros(n_floor)], 1
    )
    floor_lab = np.full(n_floor, 1, np.int32)  # 'floor'
    floor_col = np.tile([[0.6, 0.5, 0.4]], (n_floor, 1))

    walls = []
    per_wall = n_wall // 4
    for i in range(4):
        u = rng.rand(per_wall)
        z = rng.rand(per_wall) * lz
        if i == 0:
            w = np.stack([u * lx, np.zeros(per_wall), z], 1)
        elif i == 1:
            w = np.stack([u * lx, np.full(per_wall, ly), z], 1)
        elif i == 2:
            w = np.stack([np.zeros(per_wall), u * ly, z], 1)
        else:
            w = np.stack([np.full(per_wall, lx), u * ly, z], 1)
        walls.append(w)
    walls = np.concatenate(walls)
    wall_lab = np.zeros(len(walls), np.int32)  # 'wall'
    wall_col = np.tile([[0.85, 0.85, 0.8]], (len(walls), 1))

    boxes, box_lab, box_col = [], [], []
    per_box = max(n_box // max(num_boxes, 1) // 6, 8)
    # class-correlated appearance (like real furniture): each class gets its
    # palette color with per-instance jitter, so 2D appearance carries class
    # signal that pure geometry lacks
    from mvkpconv_tpu_torch.data.meta import SCANNET_COLOR_PALETTE

    palette = np.asarray(SCANNET_COLOR_PALETTE, np.float32) / 255.0
    if family == "boxes":
        box_classes = rng.choice([2, 3, 4, 5, 6, 7, 19], size=num_boxes)
        obj_iter = [("box", int(c)) for c in box_classes]
    else:
        # class identity == curvature profile; radii chosen in the
        # 0.1–0.5 m band, comparable to the L1–L3 kernel extents
        # (dl 0.05 × conv_radius 2.5 doubling per layer: 0.125/0.25/0.5 m)
        kinds = [("cyl", 2), ("sphere", 4), ("arch", 7), ("tilted_cyl", 19)]
        obj_iter = [kinds[b % len(kinds)] for b in range(num_boxes)]
    for b, (kind, cls) in enumerate(obj_iter):
        n_obj = per_box * 6
        if kind == "box":
            size = rng.uniform(0.4, 1.4, 3) * np.array([1, 1, 0.8])
            center = np.array(
                [rng.uniform(1, lx - 1), rng.uniform(1, ly - 1), size[2] / 2]
            )
            pts = _box_points(rng, center, size, per_box)
        elif kind == "cyl":
            radius = rng.uniform(0.15, 0.5)
            height = rng.uniform(0.8, min(2.0, lz - 0.2))
            pts = _cylinder_points(rng, radius, height, n_obj)
            center = np.array(
                [rng.uniform(1, lx - 1), rng.uniform(1, ly - 1), height / 2]
            )
            pts = pts + center
        elif kind == "tilted_cyl":
            radius = rng.uniform(0.12, 0.35)
            height = rng.uniform(0.8, 1.8)
            pts = _cylinder_points(rng, radius, height, n_obj)
            pts = pts @ _rotation(rng, max_tilt=0.6).T
            zmin = pts[:, 2].min()
            center = np.array(
                [rng.uniform(1, lx - 1), rng.uniform(1, ly - 1), -zmin + 0.02]
            )
            pts = pts + center
        elif kind == "sphere":
            radius = rng.uniform(0.2, 0.45)
            pts = _sphere_shell_points(rng, radius, n_obj)
            center = np.array(
                [rng.uniform(1, lx - 1), rng.uniform(1, ly - 1),
                 rng.uniform(radius, 1.2)]
            )
            pts = pts + center
        else:  # arch
            major = rng.uniform(0.4, 0.9)
            minor = rng.uniform(0.08, 0.18)
            pts = _arch_points(rng, major, minor, n_obj)
            pts = pts @ _rotation(rng, max_tilt=0.0).T  # yaw only
            center = np.array(
                [rng.uniform(1.2, lx - 1.2), rng.uniform(1.2, ly - 1.2), 0.0]
            )
            pts = pts + center
        boxes.append(pts)
        box_lab.append(np.full(len(pts), cls, np.int32))
        base = palette[cls] + rng.normal(scale=0.05, size=3)
        box_col.append(np.tile(np.clip(base, 0, 1)[None], (len(pts), 1)))
    boxes = np.concatenate(boxes)
    box_lab = np.concatenate(box_lab)
    box_col = np.concatenate(box_col)

    points = np.concatenate([floor, walls, boxes]).astype(np.float32)
    colors = np.concatenate([floor_col, wall_col, box_col]).astype(np.float32)
    labels = np.concatenate([floor_lab, wall_lab, box_lab]).astype(np.int32)
    points += rng.normal(scale=0.004, size=points.shape).astype(np.float32)
    # a few unlabeled points (ignore −1), like raw ScanNet
    drop = rng.rand(len(points)) < 0.02
    labels[drop] = -1
    return {"points": points, "colors": colors, "labels": labels}


def make_intrinsics(h: int, w: int, fov_deg: float = 60.0) -> np.ndarray:
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def _look_at(eye, target, up=(0, 0, 1.0)) -> np.ndarray:
    """Camera-to-world pose, +z looking at the target (pinhole convention)."""
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, eye
    return pose


def render_views(
    scene: Dict[str, np.ndarray],
    num_views: int,
    h: int,
    w: int,
    seed: int = 0,
    fov_deg: float = 60.0,
):
    """Render depth + RGB from the scene point cloud with a z-buffer.

    Returns dict(rgb (V,H,W,3), depth (V,H,W), poses (V,4,4) cam-to-world,
    intrinsics (V,3,3)). Pixels no point projects to have depth 0 (invalid),
    matching ScanNet's invalid-depth convention.
    """
    rng = np.random.RandomState(seed + 1)
    pts, cols = scene["points"], scene["colors"]
    labs = scene.get("labels")
    center = pts.mean(0)
    K = make_intrinsics(h, w, fov_deg)
    rgb = np.zeros((num_views, h, w, 3), np.float32)
    depth = np.zeros((num_views, h, w), np.float32)
    label = np.full((num_views, h, w), -1, np.int32)
    poses = np.zeros((num_views, 4, 4), np.float32)
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views + rng.uniform(-0.3, 0.3)
        eye = center + np.array(
            [2.2 * np.cos(ang), 2.2 * np.sin(ang), rng.uniform(0.6, 1.4)]
        )
        pose = _look_at(eye, center + rng.normal(scale=0.2, size=3))
        poses[v] = pose
        world2cam_r = pose[:3, :3].T
        cam = (pts - pose[:3, 3]) @ world2cam_r.T
        z = cam[:, 2]
        front = z > 0.05
        u = np.round(cam[:, 0] / z * K[0, 0] + K[0, 2]).astype(np.int64)
        vv = np.round(cam[:, 1] / z * K[1, 1] + K[1, 2]).astype(np.int64)
        ok = front & (u >= 0) & (u < w) & (vv >= 0) & (vv < h)
        flat = vv[ok] * w + u[ok]
        zo = z[ok]
        # z-buffer: nearest point wins (sort descending, later write wins)
        order = np.argsort(-zo, kind="stable")
        dbuf = depth[v].reshape(-1)
        cbuf = rgb[v].reshape(-1, 3)
        dbuf[flat[order]] = zo[order]
        cbuf[flat[order]] = cols[ok][order]
        if labs is not None:
            lbuf = label[v].reshape(-1)
            lbuf[flat[order]] = labs[ok][order]
    return {
        "rgb": rgb,
        "depth": depth,
        "label": label,
        "poses": poses,
        "intrinsics": np.tile(K[None], (num_views, 1, 1)),
    }
