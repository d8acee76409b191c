"""Chunk datasets for the MVPNet path (2D frames + fixed-size point chunks).

A copy of ``mvkpconv_tpu/data/chunks.py`` (numpy only), with the frame
overlap from the port's ``data/spheres.py``; ``tests/test_torch_data.py``
pins it to the original (same seed, equal arrays).

Re-design of mvpnet/data/scannet_2d3d.py:
  * ``ChunkDataset`` ↔ ScanNet2D3DChunks (:42-427): random 1.5×1.5 m xy
    chunks with ≥ a minimum labeled fraction, resampled (with replacement)
    to exactly ``num_points`` — so the PN2 path needs no padding masks;
    greedy max-coverage frame selection (:20-30); depth unprojection and the
    pixel→point kNN moved on device (the model computes knn_indices from
    depth/poses, replacing the CPU sklearn 3-NN :309-313).
  * ``SlidingChunks`` ↔ ScanNet2D3DChunksTest (:474-565) + scene2chunks
    (mvpnet/utils/chunk_util.py:4-53): stride-0.5 sliding windows covering a
    whole scene, each resampled to the fixed size, with per-point target
    indices so logits can be accumulated back onto the full cloud and
    averaged by coverage (test_mvpnet_3d.py:144-171).
  * ``Frames2DDataset`` ↔ mvpnet/data/scannet_2d.py: per-frame image+label
    batches for 2D UNet training.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def select_frames_greedy(
    overlap: np.ndarray, inside: np.ndarray, num_views: int
) -> np.ndarray:
    """Greedy max-coverage frame choice (scannet_2d3d.py:20-30): pick frames
    covering the most not-yet-covered base points of the chunk region, over
    the per-scene precomputed (frame, base point) overlap matrix
    (spheres.compute_rgbd_overlap — the reference's rgbd-overlap design)."""
    ov = overlap[:, inside]  # (F, n_inside)
    covered = np.zeros(ov.shape[1], bool)
    chosen: List[int] = []
    for _ in range(num_views):
        gain = (ov & ~covered).sum(1)
        gain[chosen] = -1
        best = int(np.argmax(gain))
        chosen.append(best)
        covered |= ov[best]
    return np.asarray(chosen)


class ChunkDataset:
    """Random chunk sampler for MVPNet training."""

    def __init__(
        self,
        scenes: Sequence[Dict[str, np.ndarray]],
        num_points: int = 8192,
        chunk_size: float = 1.5,
        min_labeled_ratio: float = 0.3,
        num_views: int = 3,
        use_color_feature: bool = False,
        training: bool = True,
        seed: int = 0,
    ):
        self.scenes = list(scenes)
        self.num_points = num_points
        self.chunk_size = chunk_size
        self.min_labeled_ratio = min_labeled_ratio
        self.num_views = num_views
        self.use_color_feature = use_color_feature
        self.training = training
        self.rng = np.random.RandomState(seed)
        self.rgbd_overlap = []
        for s in self.scenes:
            if "depth" in s:
                from mvkpconv_tpu_torch.data.spheres import compute_rgbd_overlap

                self.rgbd_overlap.append(
                    compute_rgbd_overlap(s, self.rng, overlap_radius=0.2,
                                         stride=6)
                )
            else:
                self.rgbd_overlap.append(None)

    def _sample_chunk_indices(self, scene) -> np.ndarray:
        pts = scene["points"]
        labels = scene["labels"]
        for _ in range(32):  # rejection sample (scannet_2d3d.py:337-381)
            center = pts[self.rng.randint(len(pts))][:2]
            half = self.chunk_size / 2
            inside = np.flatnonzero(
                (np.abs(pts[:, 0] - center[0]) < half)
                & (np.abs(pts[:, 1] - center[1]) < half)
            )
            if len(inside) < 64:
                continue
            if (labels[inside] >= 0).mean() >= self.min_labeled_ratio:
                return inside
        return inside  # fall through with last candidate

    def _finalize(self, scene, si, inside) -> Dict[str, np.ndarray]:
        resample = self.rng.choice(inside, self.num_points, replace=True)
        pts = scene["points"][resample]
        item = {
            "points": pts.astype(np.float32),
            "labels": scene["labels"][resample].astype(np.int32),
            "colors": scene["colors"][resample].astype(np.float32),
            "point_indices": resample,
            "scene_index": si,
        }
        if self.rgbd_overlap[si] is not None:
            base, overlap = self.rgbd_overlap[si]
            lo, hi = pts.min(0), pts.max(0)
            inside = np.flatnonzero(
                (base[:, 0] >= lo[0]) & (base[:, 0] <= hi[0])
                & (base[:, 1] >= lo[1]) & (base[:, 1] <= hi[1])
            )
            if len(inside) == 0:
                inside = np.arange(len(base))
            frames = select_frames_greedy(overlap, inside, self.num_views)
            item.update(
                images=scene["rgb"][frames],
                depth=scene["depth"][frames],
                intrinsics=scene["intrinsics"][frames],
                poses=scene["poses"][frames],
            )
        if self.use_color_feature:
            item["features"] = item["colors"]
        return item

    def sample_chunk(self) -> Dict[str, np.ndarray]:
        si = self.rng.randint(len(self.scenes))
        inside = self._sample_chunk_indices(self.scenes[si])
        return self._finalize(self.scenes[si], si, inside)

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        items = [self.sample_chunk() for _ in range(batch_size)]
        out = {}
        for key in items[0]:
            vals = [it[key] for it in items]
            out[key] = vals if key == "point_indices" else np.stack(vals) \
                if np.ndim(vals[0]) > 0 else np.asarray(vals)
        return out

    def batches(self, batch_size: int, num_batches: Optional[int] = None):
        i = 0
        while num_batches is None or i < num_batches:
            yield self.sample_batch(batch_size)
            i += 1


class SlidingChunks:
    """Whole-scene sliding-window chunks for MVPNet testing."""

    def __init__(self, chunk_dataset: ChunkDataset, stride: float = 0.5):
        self.ds = chunk_dataset
        self.stride = stride

    def scene_chunks(self, si: int) -> Iterator[Dict[str, np.ndarray]]:
        scene = self.ds.scenes[si]
        pts = scene["points"]
        half = self.ds.chunk_size / 2
        xmin, ymin = pts[:, :2].min(0)
        xmax, ymax = pts[:, :2].max(0)
        xs = np.arange(xmin + half, xmax + self.stride, self.stride)
        ys = np.arange(ymin + half, ymax + self.stride, self.stride)
        for cx in xs:
            for cy in ys:
                inside = np.flatnonzero(
                    (np.abs(pts[:, 0] - cx) < half) & (np.abs(pts[:, 1] - cy) < half)
                )
                if len(inside) < 32:
                    continue
                yield self.ds._finalize(scene, si, inside)


class Frames2DDataset:
    """Per-frame RGB + 2D label batches for UNet training
    (mvpnet/data/scannet_2d.py equivalent; jitter/flip augmentation)."""

    def __init__(self, scenes: Sequence[Dict], training: bool = True, seed: int = 0,
                 flip_prob: float = 0.5):
        self.frames = []
        for s in scenes:
            if "rgb" not in s:
                continue
            for f in range(len(s["rgb"])):
                self.frames.append((s, f))
        self.training = training
        self.flip_prob = flip_prob
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.frames)

    def _assemble(self, idx) -> Dict[str, np.ndarray]:
        imgs, labs = [], []
        for i in idx:
            scene, f = self.frames[i]
            img = scene["rgb"][f].copy()
            lab = scene["label"][f].copy()
            if self.training and self.rng.rand() < self.flip_prob:
                img, lab = img[:, ::-1], lab[:, ::-1]
            if self.training:
                img = np.clip(img * self.rng.uniform(0.8, 1.2), 0, 1)
            imgs.append(img.astype(np.float32))
            labs.append(lab.astype(np.int32))
        return {"images": np.stack(imgs), "labels": np.stack(labs)}

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = (
            self.rng.randint(0, len(self.frames), batch_size)
            if self.training
            else np.arange(batch_size) % len(self.frames)
        )
        return self._assemble(idx)

    def batches(self, batch_size: int, num_batches: Optional[int] = None):
        i = 0
        while num_batches is None or i < num_batches:
            yield self.sample_batch(batch_size)
            i += 1

    def iter_batches(self, batch_size: int):
        """Ordered one-pass sweep of EVERY frame (for full-set evaluation,
        mvpnet/test_2d.py:1-187): yields (batch, count) where the last
        batch wraps to keep the static shape and ``count`` is how many
        leading rows are real (un-wrapped) frames."""
        n = len(self.frames)
        for start in range(0, n, batch_size):
            idx = [(start + j) % n for j in range(batch_size)]
            yield self._assemble(idx), min(batch_size, n - start)
