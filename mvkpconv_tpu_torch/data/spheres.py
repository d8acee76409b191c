"""Sphere-sampling dataset: potentials, packing, feature assembly, views.

A copy of ``mvkpconv_tpu/data/spheres.py``: the voxel subsample and the
frame-overlap 1-NN take the native C++ host ops (``data/native.py``) where
they load, and their numpy fallbacks elsewhere, as the original does (the
1-NN with the hash grid's own cell size: the same distances, see
``compute_rgbd_overlap``). A dataset made from the same scenes and seed
gives the batches the JAX package gives, both on the native ops or both on
the fallbacks (``tests/test_torch_data.py``, ``tests/test_torch_native.py``).

Host-side re-design of the reference's production dataset
(KPConv-PyTorch/datasets/ScanNet_sphere_color.py, 1862 LoC): the stateful,
cheap logic stays on the host in numpy (potential-based sphere picking
:494-560, greedy frame selection :352-420, feature assembly :664-790), while
everything per-batch-expensive (grid pyramid, radius neighbors, unprojection
kNN) moved on device (ops/pyramid.py, ops/unproject.py).

Static-shape deltas from the reference:
  * fixed B spheres per batch padded to N0 points each (instead of the
    shared-memory P-controller packing to a point budget, :1249-1324);
  * frame selection returns exactly ``num_views`` frames;
  * spheres are centered at the picked point (input_points − center) like
    the reference; the height feature uses the uncentered z.

Scene dict schema (synthetic.make_scene or scannet_io loaders):
  points (N,3) float32, colors (N,3) float32, labels (N,) int32 in [0,C)∪{−1}
  optional views: rgb (F,H,W,3), depth (F,H,W), poses (F,4,4), intrinsics (F,3,3)
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from mvkpconv_tpu_torch.data.transforms import augment_points
from mvkpconv_tpu_torch.ops.common import SHADOW_COORD


def grid_subsample_np(points, colors, labels, cell: float, num_classes: int = 20):
    """Host-side voxel barycenter subsample (one-off per scene at load time,
    mirroring load_subsampled_clouds' cached first-run subsample :880).

    Uses the native C++ implementation (csrc/host_ops.cpp) when available;
    falls back to vectorized numpy."""
    from mvkpconv_tpu_torch.data.native import grid_subsample_native

    native = grid_subsample_native(points, colors, labels, cell, num_classes)
    if native is not None:
        return native
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
    pts = np.stack(
        [np.bincount(seg, weights=points[order][:, i], minlength=n) for i in range(3)], 1
    ) / cnt[:, None]
    cols = np.stack(
        [np.bincount(seg, weights=colors[order][:, i], minlength=n) for i in range(3)], 1
    ) / cnt[:, None]
    lab = labels[order].astype(np.int64)
    votes = np.zeros((n, num_classes), np.int64)
    valid = lab >= 0
    np.add.at(votes, (seg[valid], lab[valid]), 1)
    maj = np.where(votes.sum(1) > 0, votes.argmax(1), -1).astype(np.int32)
    return pts.astype(np.float32), cols.astype(np.float32), maj


def assemble_features(
    points_abs: np.ndarray, colors: np.ndarray, base_dim: int, use_point_color: bool
) -> np.ndarray:
    """Base 3D feature columns by dimension, following the reference's
    switches (ScanNet_sphere_color.py:725-790 / ScanNet_baseline_color.py:472-492):
      1 → [1]; 2 → [1,z]; 4 → [1,rgb] (or [1,xyz] if not use_point_color);
      5 → [1,rgb,z]; 7 → [1,rgb,xyz]. ``z`` is the uncentered height.
    For fusion models pass base_dim = in_features_dim − feature_2d_dim.
    """
    n = len(points_abs)
    ones = np.ones((n, 1), np.float32)
    z = points_abs[:, 2:3]
    if base_dim == 1:
        cols = [ones]
    elif base_dim == 2:
        cols = [ones, z]
    elif base_dim == 4:
        cols = [ones, colors] if use_point_color else [ones, points_abs]
    elif base_dim == 5:
        cols = [ones, colors, z]
    elif base_dim == 7:
        cols = [ones, colors, points_abs]
    else:
        raise ValueError(f"unsupported base feature dim {base_dim}")
    return np.concatenate(cols, 1).astype(np.float32)


def compute_rgbd_overlap(
    scene, rng, n_base: int = 2048, overlap_radius: float = 0.1, stride: int = 4
):
    """One-off per-scene (base point, frame) coverage matrix.

    Mirrors the reference's precomputed RGB-D overlap
    (get_rgbd_overlap_subcloud.py:68-138: sample base points, mark those
    with an unprojected pixel within 0.1 m per frame) so per-sample frame
    selection is a tiny greedy over base points instead of per-pixel
    distance sweeps. Uses the native hash-grid 1-NN when available.

    Returns:
      (base (nb, 3) float32, overlap (F, nb) bool).
    """
    from mvkpconv_tpu_torch.data.native import nearest_neighbor_1nn_native

    clouds = SphereDataset._frame_pixel_clouds(scene, stride=stride)
    pts = scene["points"]
    sel = rng.choice(len(pts), min(n_base, len(pts)), replace=False)
    base = pts[sel].astype(np.float32)
    cols = []
    for f in range(len(clouds)):
        pix = clouds[f]
        pix = pix[pix[:, 0] < SHADOW_COORD / 2]  # drop invalid-depth pixels
        if len(pix) == 0:
            cols.append(np.zeros(len(base), bool))
            continue
        # the hash grid's own cell (the pixels' mean spacing), where the JAX
        # package passes overlap_radius: the 1-NN is exact for any cell, so
        # the distances are the same bits, but at 0.1 m the ring search
        # walks up to 64 rings of cells for each base point outside the
        # frame, 20-300x numpy's time (PERF.md, chip_smoke.py overlap_nn)
        res = nearest_neighbor_1nn_native(base, pix)
        if res is None:
            d2 = ((base[:, None] - pix[None]) ** 2).sum(-1).min(1)
        else:
            _, d2 = res
        cols.append(d2 < overlap_radius**2)
    return base, np.stack(cols)


HOST_ONLY_KEYS = ("scene_index", "center", "point_indices")


def device_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip host-only bookkeeping keys before shipping a batch to device."""
    return {k: v for k, v in batch.items() if k not in HOST_ONLY_KEYS}


class SphereDataset:
    """Potential-sampled sphere batches over a list of scenes."""

    def __init__(
        self,
        scenes: Sequence[Dict[str, np.ndarray]],
        cfg,
        training: bool = True,
        seed: int = 0,
        subsample: bool = True,
    ):
        self.cfg = cfg
        self.training = training
        self.rng = np.random.RandomState(seed)
        self.scenes = []
        for s in scenes:
            if subsample:
                pts, cols, lab = grid_subsample_np(
                    s["points"], s["colors"], s["labels"],
                    cfg.first_subsampling_dl, cfg.num_classes,
                )
            else:
                pts, cols, lab = s["points"], s["colors"], s["labels"]
            scene = dict(s, points=pts, colors=cols, labels=lab)
            if "depth" in s:
                scene["rgbd_overlap"] = self._rgbd_overlap(scene)
            self.scenes.append(scene)
        # coarse potential grid per scene (dl = in_radius/10, :880)
        self.pot_points = []
        self.potentials = []
        for s in self.scenes:
            coarse, _, _ = grid_subsample_np(
                s["points"], s["points"], np.zeros(len(s["points"]), np.int32),
                cfg.in_radius / 10.0, 1,
            )
            self.pot_points.append(coarse)
            self.potentials.append(self.rng.rand(len(coarse)) * 1e-3)
        # per-stage wall-clock of sample_sphere, seconds per call, appended
        # on every call (perf_counter overhead is negligible next to the
        # numpy work), plus raw in-sphere point counts BEFORE the crop.
        # tools/inspect_dataset.py reports these — the analog of the
        # reference's debug_timing (ScanNet_sphere_color.py:1694).
        self.stage_times: Dict[str, List[float]] = defaultdict(list)
        self.sphere_counts: List[int] = []

    @staticmethod
    def _frame_pixel_clouds(scene, stride: int = 4):
        """Subsampled unprojected pixels per frame, for frame selection
        (replaces the precomputed rgbd overlap matrix,
        get_rgbd_overlap_subcloud.py:68-138)."""
        depth = scene["depth"][:, ::stride, ::stride]
        K = scene["intrinsics"].copy()
        K[:, :2] /= stride
        f, h, w = depth.shape
        us, vs = np.meshgrid(np.arange(w), np.arange(h))
        clouds = []
        for i in range(f):
            z = depth[i]
            x = (us - K[i, 0, 2]) * z / K[i, 0, 0]
            y = (vs - K[i, 1, 2]) * z / K[i, 1, 1]
            cam = np.stack([x, y, z], -1).reshape(-1, 3)
            ok = z.reshape(-1) > 0
            world = cam @ scene["poses"][i][:3, :3].T + scene["poses"][i][:3, 3]
            world[~ok] = SHADOW_COORD
            clouds.append(world.astype(np.float32))
        return np.stack(clouds)  # (F, hw, 3)

    def _rgbd_overlap(self, scene, n_base: int = 2048, overlap_radius: float = 0.1):
        return compute_rgbd_overlap(scene, self.rng, n_base, overlap_radius)

    def _select_frames(self, scene, center) -> np.ndarray:
        """Greedy max-coverage frame choice near the sphere center
        (ScanNet_sphere_color.py:352-420 greedy select_frames over the
        precomputed base-point overlap matrix)."""
        base, overlap = scene["rgbd_overlap"]
        inside = np.sum((base - center) ** 2, 1) < self.cfg.in_radius**2
        ov = overlap[:, inside]  # (F, n_inside)
        chosen = []
        covered = np.zeros(ov.shape[1], bool)
        for _ in range(self.cfg.num_views):
            gain = (ov & ~covered).sum(1)
            gain[chosen] = -1
            best = int(np.argmax(gain))
            chosen.append(best)
            covered |= ov[best]
        return np.asarray(chosen)

    def _pick_center(self):
        """argmin-potential pick + Tukey potential update (:494-560)."""
        mins = [p.min() for p in self.potentials]
        si = int(np.argmin(mins))
        pi = int(np.argmin(self.potentials[si]))
        center = self.pot_points[si][pi]
        if self.training:
            center = center + self.rng.normal(scale=self.cfg.in_radius / 10, size=3)
        d2 = np.sum((self.pot_points[si] - center) ** 2, 1)
        r2 = self.cfg.in_radius**2
        tukey = np.square(1 - d2 / r2)
        tukey[d2 > r2] = 0
        self.potentials[si] += tukey
        return si, center.astype(np.float32)

    def min_potential(self) -> float:
        return float(min(p.min() for p in self.potentials))

    def sample_sphere(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        tick = time.perf_counter()

        def lap(stage):
            nonlocal tick
            now = time.perf_counter()
            self.stage_times[stage].append(now - tick)
            tick = now

        si, center = self._pick_center()
        lap("pick_center")
        scene = self.scenes[si]
        pts = scene["points"]
        d2 = np.sum((pts - center) ** 2, 1)
        inds = np.flatnonzero(d2 < cfg.in_radius**2)
        self.sphere_counts.append(len(inds))
        n0 = cfg.num_points[0]
        if len(inds) > n0:
            inds = self.rng.choice(inds, n0, replace=False)
        sphere_abs = pts[inds]
        colors = scene["colors"][inds]
        labels = scene["labels"][inds]
        lap("crop")
        if self.training and self.rng.rand() > cfg.augment_color:
            # color-drop augmentation (ScanNet_sphere_color feature assembly:
            # with probability 1−augment_color the point colors are zeroed)
            colors = np.zeros_like(colors)

        base_dim = cfg.in_features_dim - (
            cfg.feature_2d_dim if cfg.fusion != "none" else 0
        )
        features = assemble_features(sphere_abs, colors, base_dim, cfg.use_point_color)
        points = sphere_abs - center
        lap("features")

        item = {"scene_index": si, "center": center, "point_indices": inds}
        if "rgbd_overlap" in scene:
            frames = self._select_frames(scene, center)
            item.update(
                images=scene["rgb"][frames],
                depth=scene["depth"][frames],
                intrinsics=scene["intrinsics"][frames],
                poses=self._centered_poses(scene["poses"][frames], center),
            )
            lap("select_frames")
        if self.training:
            extra = None
            points, extra, R, scale = augment_points(points, cfg, self.rng)
            if "poses" in item:
                item["poses"] = self._augment_poses(item["poses"], R, scale)
            lap("augment")
        n = len(points)
        pad = n0 - n

        def padded(a, fill=0):
            width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, width, constant_values=fill)

        item.update(
            points=padded(points.astype(np.float32), SHADOW_COORD),
            mask=padded(np.ones(n, bool)),
            features=padded(features),
            labels=padded(labels, cfg.ignore_label),
        )
        if "feature_2d3d" in scene:
            # precomputed whole-scene lifted 2D features, sliced per sphere
            # (the ScanNet_new.py:413-417 input_inds route)
            item["feature_2d3d"] = padded(scene["feature_2d3d"][inds])
        lap("pad")
        return item

    @staticmethod
    def _centered_poses(poses, center):
        out = poses.copy()
        out[:, :3, 3] -= center
        return out

    @staticmethod
    def _augment_poses(poses, R, scale):
        """Compose the point augmentation into cam-to-world poses so
        unprojected pixels land in augmented point coordinates
        (augmentation_transform_new, common.py:331-409). Scale flips break
        rotation orthonormality, so we fold scale into a 3×3 linear map."""
        # points transform as p' = (p @ R.T) ∘ scale = (diag(scale) · R) p
        A = (scale[:, None] * R).astype(np.float32)
        out = poses.copy()
        out[:, :3, :3] = np.einsum("ij,fjk->fik", A, poses[:, :3, :3])
        out[:, :3, 3] = np.einsum("ij,fj->fi", A, poses[:, :3, 3])
        return out

    def sample_batch(self, batch_size: Optional[int] = None) -> Dict[str, np.ndarray]:
        b = batch_size or self.cfg.batch_num
        items = [self.sample_sphere() for _ in range(b)]
        batch = {}
        for key in items[0]:
            vals = [it[key] for it in items]
            if key == "point_indices":  # ragged — for eval reprojection only
                batch[key] = vals
            elif np.ndim(vals[0]) > 0:
                batch[key] = np.stack(vals)
            else:
                batch[key] = np.asarray(vals)
        return batch

    def batches(self, num_batches: Optional[int] = None, batch_size=None):
        i = 0
        while num_batches is None or i < num_batches:
            yield self.sample_batch(batch_size)
            i += 1
