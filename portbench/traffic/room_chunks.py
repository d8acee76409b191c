"""The generator ``room_chunks``: chunk batches cut from seeded rooms as
MVPNet's whole-scene test cuts a scene (``mvpnet/test_mvpnet_3d.py`` with
``mvpnet/utils/chunk_util.py:scene2chunks``): sliding windows of
``chunk_size_m`` × ``chunk_size_m`` in xy at a stride of ``stride_m``, each
window's points resampled with replacement to the configuration's
``chunk_points``, and its ``num_views`` frames chosen by greedy coverage of
the room's RGB-D overlap. A frozen copy, numpy only, of the port's
``data/chunks.py`` (``SlidingChunks``, ``ChunkDataset._finalize``,
``select_frames_greedy``) on the rooms of ``rooms.py``, so that a change to
the program cannot move the benchmark's inputs.

A batch holds what ``tools/test_mvpnet.py`` hands to the step (the keys
that ``train_mvpnet.chunk_batch(..., no_images=False)`` keeps: ``points``,
``labels``, ``images``, ``depth``, ``intrinsics``, ``poses``; points and
poses in the room's own coordinates, as the test leaves them) and
``mask``, all True, which only the benchmark reads (``Pool.fill``).

Keys of its mixes:
  rooms, points_per_room, room_size_m, boxes_per_room, frames_per_room,
  room_seed        the rooms, as ``room_spheres``'s (the same in every run)
  chunk_size_m, stride_m, min_chunk_points
                   the sliding windows; a window with fewer points is
                   skipped (``SlidingChunks``' 32)
  overlap_radius_m, overlap_stride
                   the RGB-D overlap the views are chosen by (the port's
                   chunk datasets: 0.2 m, every 6th pixel)
  pool_batches     batches made in set-up and cycled through in order
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from portbench.traffic.generator import Pool, seeds
from portbench.traffic.rooms import make_room, render_views
from portbench.traffic.spheres import SHADOW_COORD, _frame_pixel_clouds

OVERLAP_BASE = 2048  # base points of a room's RGB-D overlap


def rgbd_overlap(room, rng, radius: float, stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """(base points (nb, 3), overlap (F, nb) bool): which base points have
    an unprojected pixel (every ``stride``-th) of each frame within
    ``radius``, by an exact 1-NN."""
    from scipy.spatial import cKDTree

    pts = room["points"]
    base = pts[rng.choice(len(pts), min(OVERLAP_BASE, len(pts)), replace=False)].astype(np.float32)
    cols = []
    for pix in _frame_pixel_clouds(room, stride):
        pix = pix[pix[:, 0] < SHADOW_COORD / 2]
        if len(pix) == 0:
            cols.append(np.zeros(len(base), bool))
            continue
        dist, _ = cKDTree(pix).query(base, k=1)
        cols.append(dist < radius)
    return base, np.stack(cols)


def select_frames(overlap: np.ndarray, inside: np.ndarray, num_views: int) -> np.ndarray:
    """Greedy max coverage (scannet_2d3d.py:20-30): each next frame the one
    that covers the most base points of the chunk not yet covered."""
    ov = overlap[:, inside]
    covered = np.zeros(ov.shape[1], bool)
    chosen: List[int] = []
    for _ in range(num_views):
        gain = (ov & ~covered).sum(1)
        gain[chosen] = -1
        best = int(np.argmax(gain))
        chosen.append(best)
        covered |= ov[best]
    return np.asarray(chosen)


def windows(points: np.ndarray, size: float, stride: float, least: int) -> List[np.ndarray]:
    """The indices of the points inside each sliding window of a room, the
    windows in ``SlidingChunks``' order (x outer, y inner)."""
    half = size / 2
    xmin, ymin = points[:, :2].min(0)
    xmax, ymax = points[:, :2].max(0)
    out = []
    for cx in np.arange(xmin + half, xmax + stride, stride):
        for cy in np.arange(ymin + half, ymax + stride, stride):
            inside = np.flatnonzero((np.abs(points[:, 0] - cx) < half) & (np.abs(points[:, 1] - cy) < half))
            if len(inside) >= least:
                out.append(inside)
    return out


def chunk(room: Dict[str, np.ndarray], inside: np.ndarray, model: Dict, rng) -> Dict[str, np.ndarray]:
    """One window resampled to the configuration's points, with its views
    (``ChunkDataset._finalize``)."""
    pick = rng.choice(inside, model["chunk_points"], replace=True)
    pts = room["points"][pick].astype(np.float32)
    base, overlap = room["overlap"]
    lo, hi = pts.min(0), pts.max(0)
    covered = np.flatnonzero((base[:, 0] >= lo[0]) & (base[:, 0] <= hi[0])
                             & (base[:, 1] >= lo[1]) & (base[:, 1] <= hi[1]))
    if len(covered) == 0:
        covered = np.arange(len(base))
    frames = select_frames(overlap, covered, model["num_views"])
    return {"points": pts, "mask": np.ones(len(pts), bool), "labels": room["labels"][pick].astype(np.int32),
            "images": room["rgb"][frames], "depth": room["depth"][frames],
            "intrinsics": room["intrinsics"][frames], "poses": room["poses"][frames]}


def make_pool(model: Dict, mix: Dict, seed: int) -> Pool:
    # The rooms, their windows and each window's resampling are the mix's
    # own, the same in every run, so that every run of a cell does as much
    # work; the run's seed draws which windows fill the pool, their order
    # and their grouping into batches (and, elsewhere, the weights).
    room_seeds = seeds(mix["room_seed"], mix["rooms"] + 1)

    def room(s):
        r = make_room(s, mix["points_per_room"], tuple(mix["room_size_m"]), mix["boxes_per_room"])
        r.update(render_views(r, mix["frames_per_room"], model["image_height"], model["image_width"], seed=s))
        r["overlap"] = rgbd_overlap(r, np.random.RandomState(s), mix["overlap_radius_m"], mix["overlap_stride"])
        r["windows"] = windows(r["points"], mix["chunk_size_m"], mix["stride_m"], mix["min_chunk_points"])
        return r

    # one thread a room (numpy releases the interpreter lock); each room's
    # draws come from its own seed, so the order of completion changes nothing
    with ThreadPoolExecutor(max_workers=min(4, mix["rooms"])) as ex:
        rooms = list(ex.map(room, room_seeds[:-1]))
    every = [(ri, wi) for ri, r in enumerate(rooms) for wi in range(len(r["windows"]))]
    b = model["batch_num"]
    need = mix["pool_batches"] * b
    run_rng = np.random.RandomState(seeds(seed, 1)[0])
    order = run_rng.choice(len(every), need, replace=need > len(every))
    chunks = []
    for j in order:
        ri, wi = every[j]
        rng = np.random.RandomState([room_seeds[-1], ri, wi])
        chunks.append(chunk(rooms[ri], rooms[ri]["windows"][wi], model, rng))
    batches = [{k: np.stack([c[k] for c in chunks[i:i + b]]) for k in chunks[0]} for i in range(0, need, b)]
    return Pool(batches, [int(x["mask"].sum()) for x in batches])
