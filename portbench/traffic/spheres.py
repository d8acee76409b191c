"""Sphere batches cut from rooms: a frozen copy of the port's per-sphere path
(``mvkpconv_tpu_torch/data/spheres.py`` ``SphereDataset`` and
``data/transforms.py``), numpy only (the port's optional native host ops
give the same arrays; the benchmark never loads them).

Per room, once: the 4 cm voxel barycenters (colors averaged, labels by
majority), the coarse potential grid (in_radius / 10) and the RGB-D overlap
of 2,048 base points with each frame. Per sphere: the center of least
potential (jittered by in_radius / 10 in training) and the Tukey update of
the potentials; the crop to in_radius (a random N0 of the points where more
fall inside); the base feature columns; the greedy choice of the views that
cover most base points in the sphere; in training, the random vertical
rotation, anisotropic scale, x-flip, jitter and colour drop, with the views'
poses moved alike; padding to N0 slots, padded points at 1e6 with mask
False and label −1.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SHADOW_COORD = 1.0e6


def grid_subsample(points, colors, labels, cell: float, num_classes: int = 20):
    """Voxel barycenters, mean colours and majority labels (−1 where a voxel
    has no labelled point), in ascending voxel-key order."""
    origin = np.floor(points.min(0) / cell)
    vox = (np.floor(points / cell) - origin).astype(np.int64)
    key = (vox[:, 0] << 40) + (vox[:, 1] << 20) + vox[:, 2]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    starts = np.r_[0, np.flatnonzero(key_s[1:] != key_s[:-1]) + 1]
    seg = np.zeros(len(key_s), np.int64)
    seg[starts] = 1
    seg = np.cumsum(seg) - 1
    n = seg[-1] + 1
    cnt = np.bincount(seg, minlength=n).astype(np.float32)
    pts = np.stack([np.bincount(seg, weights=points[order][:, i], minlength=n) for i in range(3)], 1) / cnt[:, None]
    cols = np.stack([np.bincount(seg, weights=colors[order][:, i], minlength=n) for i in range(3)], 1) / cnt[:, None]
    lab = labels[order].astype(np.int64)
    votes = np.zeros((n, num_classes), np.int64)
    valid = lab >= 0
    np.add.at(votes, (seg[valid], lab[valid]), 1)
    maj = np.where(votes.sum(1) > 0, votes.argmax(1), -1).astype(np.int32)
    return pts.astype(np.float32), cols.astype(np.float32), maj


def base_features(points_abs: np.ndarray, colors: np.ndarray, base_dim: int) -> np.ndarray:
    """The base feature columns (ScanNet_sphere_color.py:725-790): 1 → [1];
    2 → [1, z]; 4 → [1, rgb]; 5 → [1, rgb, z]; 7 → [1, rgb, xyz]; z is the
    uncentred height."""
    ones = np.ones((len(points_abs), 1), np.float32)
    z = points_abs[:, 2:3]
    cols = {1: [ones], 2: [ones, z], 4: [ones, colors], 5: [ones, colors, z],
            7: [ones, colors, points_abs]}[base_dim]
    return np.concatenate(cols, 1).astype(np.float32)


def _frame_pixel_clouds(room, stride: int = 4) -> np.ndarray:
    depth = room["depth"][:, ::stride, ::stride]
    K = room["intrinsics"].copy()
    K[:, :2] /= stride
    f, h, w = depth.shape
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    clouds = []
    for i in range(f):
        z = depth[i]
        x = (us - K[i, 0, 2]) * z / K[i, 0, 0]
        y = (vs - K[i, 1, 2]) * z / K[i, 1, 1]
        cam = np.stack([x, y, z], -1).reshape(-1, 3)
        world = cam @ room["poses"][i][:3, :3].T + room["poses"][i][:3, 3]
        world[z.reshape(-1) <= 0] = SHADOW_COORD
        clouds.append(world.astype(np.float32))
    return np.stack(clouds)


def rgbd_overlap(room, rng, n_base: int = 2048, radius: float = 0.1):
    """(base points (nb, 3), overlap (F, nb) bool): which base points have an
    unprojected pixel of each frame within ``radius``
    (get_rgbd_overlap_subcloud.py:68-138), by an exact 1-NN."""
    from scipy.spatial import cKDTree

    clouds = _frame_pixel_clouds(room)
    pts = room["points"]
    base = pts[rng.choice(len(pts), min(n_base, len(pts)), replace=False)].astype(np.float32)
    cols = []
    for pix in clouds:
        pix = pix[pix[:, 0] < SHADOW_COORD / 2]
        if len(pix) == 0:
            cols.append(np.zeros(len(base), bool))
            continue
        dist, _ = cKDTree(pix).query(base, k=1)
        cols.append(dist < radius)
    return base, np.stack(cols)


def _rotation(rng) -> np.ndarray:
    theta = rng.rand() * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def augment(points, model, rng):
    """Vertical rotation, anisotropic scale in [0.9, 1.1] with a random
    x-flip, Gaussian jitter (common.py:252-329). Returns (points, R, scale)."""
    R = _rotation(rng)
    scale = rng.uniform(model["augment_scale_min"], model["augment_scale_max"], 3)
    for ax, sym in enumerate(model["augment_symmetries"]):
        if sym and rng.rand() < 0.5:
            scale[ax] *= -1
    scale = scale.astype(np.float32)
    noise = (rng.randn(*points.shape) * model["augment_noise"]).astype(np.float32)
    return (points @ R.T * scale + noise).astype(np.float32), R, scale


def prepare_room(room: Dict[str, np.ndarray], model: Dict, rng) -> Dict[str, np.ndarray]:
    """A room as the sampler takes it: subsampled to the first cell, with its
    RGB-D overlap (fusion only; base points drawn from ``rng``) and its
    coarse potential grid."""
    pts, cols, lab = grid_subsample(room["points"], room["colors"], room["labels"],
                                    model["first_subsampling_dl"], model["num_classes"])
    out = dict(room, points=pts, colors=cols, labels=lab)
    if model["fusion"] != "none":
        out["overlap"] = rgbd_overlap(out, rng)
    out["pot_points"], _, _ = grid_subsample(pts, pts, np.zeros(len(pts), np.int32), model["in_radius"] / 10.0, 1)
    return out


class SpherePool:
    """Potential-sampled spheres over prepared rooms (:func:`prepare_room`;
    ``model`` is the configuration's model dict). ``cut_rng`` draws where
    the spheres are cut (the potentials' start, the centre jitter, the crop),
    ``aug_rng`` the augmentation."""

    def __init__(self, rooms: List[Dict[str, np.ndarray]], model: Dict, training: bool, cut_rng, aug_rng):
        self.model = model
        self.training = training
        self.cut_rng, self.rng = cut_rng, aug_rng
        self.rooms = rooms
        self.pot_points = [r["pot_points"] for r in rooms]
        self.potentials = [cut_rng.rand(len(p)) * 1e-3 for p in self.pot_points]

    def _pick_center(self):
        ri = int(np.argmin([p.min() for p in self.potentials]))
        center = self.pot_points[ri][int(np.argmin(self.potentials[ri]))]
        if self.training:
            center = center + self.cut_rng.normal(scale=self.model["in_radius"] / 10, size=3)
        d2 = np.sum((self.pot_points[ri] - center) ** 2, 1)
        r2 = self.model["in_radius"] ** 2
        tukey = np.square(1 - d2 / r2)
        tukey[d2 > r2] = 0
        self.potentials[ri] += tukey
        return ri, center.astype(np.float32)

    def _select_frames(self, room, center) -> np.ndarray:
        base, overlap = room["overlap"]
        ov = overlap[:, np.sum((base - center) ** 2, 1) < self.model["in_radius"] ** 2]
        chosen, covered = [], np.zeros(ov.shape[1], bool)
        for _ in range(self.model["num_views"]):
            gain = (ov & ~covered).sum(1)
            gain[chosen] = -1
            best = int(np.argmax(gain))
            chosen.append(best)
            covered |= ov[best]
        return np.asarray(chosen)

    def sphere(self) -> Dict[str, np.ndarray]:
        m = self.model
        ri, center = self._pick_center()
        room = self.rooms[ri]
        inds = np.flatnonzero(np.sum((room["points"] - center) ** 2, 1) < m["in_radius"] ** 2)
        n0 = m["num_points"][0]
        if len(inds) > n0:
            inds = self.cut_rng.choice(inds, n0, replace=False)
        sphere_abs = room["points"][inds]
        colors = room["colors"][inds]
        labels = room["labels"][inds]
        if self.training and self.rng.rand() > m["augment_color"]:
            colors = np.zeros_like(colors)
        base_dim = m["in_features_dim"] - (m["feature_2d_dim"] if m["fusion"] != "none" else 0)
        features = base_features(sphere_abs, colors, base_dim)
        points = sphere_abs - center
        item = {}
        if m["fusion"] != "none":
            frames = self._select_frames(room, center)
            poses = room["poses"][frames].copy()
            poses[:, :3, 3] -= center
            item.update(images=room["rgb"][frames], depth=room["depth"][frames],
                        intrinsics=room["intrinsics"][frames], poses=poses)
        if self.training:
            points, R, scale = augment(points, m, self.rng)
            if "poses" in item:
                # the point augmentation composed into the cam-to-world poses
                A = (scale[:, None] * R).astype(np.float32)
                poses = item["poses"]
                poses[:, :3, :3] = np.einsum("ij,fjk->fik", A, poses[:, :3, :3])
                poses[:, :3, 3] = np.einsum("ij,fj->fi", A, poses[:, :3, 3])
        n = len(points)

        def padded(a, fill=0):
            return np.pad(a, [(0, n0 - n)] + [(0, 0)] * (a.ndim - 1), constant_values=fill)

        item.update(points=padded(points.astype(np.float32), SHADOW_COORD), mask=padded(np.ones(n, bool)),
                    features=padded(features), labels=padded(labels, m["ignore_label"]))
        return item
