"""ScanNet raw-data IO and offline preprocessing: a copy of
``mvkpconv_tpu/data/scannet_io.py`` (``tests/test_torch_io.py`` pins it to
the original and holds its outputs equal).

Replaces the reference's L0 preprocessing layer (SURVEY.md §2.3):
  * mvpnet/data/preprocess/preprocess.py:177-289 — per-scan ply → pickle
    cache with fixed labels;
  * the raw→nyu40→20-class label mapping from scannetv2-labels.combined.tsv
    (mvpnet/data/scannet_2d.py:86-104);
  * mvpnet/data/preprocess/SensorData.py — .sens stream decoding (color
    jpeg / zlib-uint16 depth / poses / intrinsics);
  * resize_scannet_images.py — downscale frames to the training resolution;
  * compute_label_weights.py — 1/log(1.2+freq) class weights.

All pure Python/numpy host code; PIL is imported by ``load_frames`` alone.
"""

from __future__ import annotations

import pickle
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mvkpconv_tpu_torch.data.meta import NUM_CLASSES, NYU40_EVAL_IDS
from mvkpconv_tpu_torch.utils.ply import read_ply


def nyu40_to_train_ids() -> np.ndarray:
    """(41,) lookup: nyu40 id → train id in [0,20) or −1."""
    lut = np.full(41, -1, np.int32)
    for train_id, nyu in enumerate(NYU40_EVAL_IDS):
        lut[nyu] = train_id
    return lut


def parse_label_mapping_tsv(tsv_path) -> Dict[int, int]:
    """raw ScanNet label id → nyu40 id (scannetv2-labels.combined.tsv)."""
    mapping = {}
    lines = Path(tsv_path).read_text().splitlines()
    header = lines[0].split("\t")
    id_col = header.index("id")
    nyu_col = header.index("nyu40id")
    for line in lines[1:]:
        parts = line.split("\t")
        try:
            mapping[int(parts[id_col])] = int(parts[nyu_col])
        except (ValueError, IndexError):
            continue
    return mapping


def compose_raw_to_train_lut(raw_to_nyu40: Dict[int, int]) -> np.ndarray:
    """Raw ScanNet label id → train id LUT.

    Composes the TSV raw→nyu40 mapping with the nyu40→train mapping exactly
    as the reference does (mvpnet/data/scannet_2d.py:86-104 builds
    ``raw_to_scannet = nyu40_to_scannet[raw_to_nyu40]``). Raw ids absent from
    the TSV, or mapping to nyu40 ids outside [0, 40], become ignore (−1).
    """
    nyu_lut = nyu40_to_train_ids()
    size = max(raw_to_nyu40.keys()) + 1
    lut = np.full(size, -1, np.int32)
    for raw, nyu in raw_to_nyu40.items():
        if 0 <= raw and 0 <= nyu <= 40:
            lut[raw] = nyu_lut[nyu]
    return lut


def load_scene(
    scan_dir, scan_id: str, label_lut: Optional[np.ndarray] = None
) -> Dict[str, np.ndarray]:
    """Load `<scan>_vh_clean_2.ply` (+ `.labels.ply`) into a scene dict.

    Labels come as nyu40 ids in the labels ply; they are mapped to train ids
    [0,20) with −1 ignore. Bad label ids (>40, preprocess.py:216-222) are
    clamped to ignore.
    """
    scan_dir = Path(scan_dir)
    mesh = read_ply(scan_dir / f"{scan_id}_vh_clean_2.ply")
    points = np.stack([mesh["x"], mesh["y"], mesh["z"]], 1).astype(np.float32)
    colors = (
        np.stack([mesh["red"], mesh["green"], mesh["blue"]], 1).astype(np.float32)
        / 255.0
    )
    scene = {"scan_id": scan_id, "points": points, "colors": colors}
    label_path = scan_dir / f"{scan_id}_vh_clean_2.labels.ply"
    if label_path.exists():
        lab = read_ply(label_path)["label"].astype(np.int64)
        lab[(lab < 0) | (lab > 40)] = 0  # bad ids → unannotated
        lut = label_lut if label_lut is not None else nyu40_to_train_ids()
        scene["labels"] = lut[lab].astype(np.int32)
    else:
        scene["labels"] = np.full(len(points), -1, np.int32)
    return scene


def preprocess_split(
    scans_root,
    scan_ids: Sequence[str],
    output_pkl,
    verbose: bool = False,
) -> List[Dict[str, np.ndarray]]:
    """Build the per-split pickle cache (preprocess.py:177-289 equivalent)."""
    lut = nyu40_to_train_ids()
    scenes = []
    for sid in scan_ids:
        scenes.append(load_scene(Path(scans_root) / sid, sid, lut))
        if verbose:
            print(f"preprocessed {sid}: {len(scenes[-1]['points'])} points")
    with open(output_pkl, "wb") as f:
        pickle.dump(scenes, f)
    return scenes


def load_split(pkl_path) -> List[Dict[str, np.ndarray]]:
    with open(pkl_path, "rb") as f:
        return pickle.load(f)


def compute_label_weights(scenes: Sequence[Dict], num_classes: int = NUM_CLASSES):
    """1/log(1.2+freq) class weights (compute_label_weights.py)."""
    counts = np.zeros(num_classes, np.float64)
    for s in scenes:
        lab = s["labels"]
        counts += np.bincount(lab[lab >= 0], minlength=num_classes)
    freq = counts / max(counts.sum(), 1.0)
    return (1.0 / np.log(1.2 + freq)).astype(np.float32)


# --------------------------------------------------------------------------
# .sens stream decoding (SensorData.py behavior; format is public)
# --------------------------------------------------------------------------

_COMPRESSION_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
_COMPRESSION_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}


class SensReader:
    """Streaming reader for ScanNet ``.sens`` files."""

    def __init__(self, path):
        self.f = open(path, "rb")
        (self.version,) = struct.unpack("<I", self.f.read(4))
        (strlen,) = struct.unpack("<Q", self.f.read(8))
        self.sensor_name = self.f.read(strlen).decode("ascii", errors="replace")
        self.intrinsic_color = np.frombuffer(self.f.read(64), "<f4").reshape(4, 4)
        self.extrinsic_color = np.frombuffer(self.f.read(64), "<f4").reshape(4, 4)
        self.intrinsic_depth = np.frombuffer(self.f.read(64), "<f4").reshape(4, 4)
        self.extrinsic_depth = np.frombuffer(self.f.read(64), "<f4").reshape(4, 4)
        (c,) = struct.unpack("<i", self.f.read(4))
        self.color_compression = _COMPRESSION_COLOR[c]
        (d,) = struct.unpack("<i", self.f.read(4))
        self.depth_compression = _COMPRESSION_DEPTH[d]
        (self.color_width,) = struct.unpack("<I", self.f.read(4))
        (self.color_height,) = struct.unpack("<I", self.f.read(4))
        (self.depth_width,) = struct.unpack("<I", self.f.read(4))
        (self.depth_height,) = struct.unpack("<I", self.f.read(4))
        (self.depth_shift,) = struct.unpack("<f", self.f.read(4))
        (self.num_frames,) = struct.unpack("<Q", self.f.read(8))

    def frames(self):
        """Yield (pose 4×4, color_bytes, depth (H,W) float32 metres)."""
        for _ in range(self.num_frames):
            pose = np.frombuffer(self.f.read(64), "<f4").reshape(4, 4)
            self.f.read(16)  # timestamps
            (color_size,) = struct.unpack("<Q", self.f.read(8))
            (depth_size,) = struct.unpack("<Q", self.f.read(8))
            color = self.f.read(color_size)
            depth_raw = self.f.read(depth_size)
            if self.depth_compression == "zlib_ushort":
                depth_raw = zlib.decompress(depth_raw)
            depth = np.frombuffer(depth_raw, "<u2").reshape(
                self.depth_height, self.depth_width
            )
            yield pose, color, depth.astype(np.float32) / self.depth_shift

    def close(self):
        self.f.close()


# Known-problematic sensor frames (depth all-zero or unreadable labels),
# ported from the reference's blacklist (mvpnet/data/scannet_2d3d.py:53-58
# ``exclude_frames``). Frame ids are ints here (our frame_ids convention).
EXCLUDE_FRAMES = {
    "scene0243_00": tuple(range(1175, 1185)),
    "scene0538_00": (1925, 1928, 1929, 1931, 1932, 1933),
    "scene0639_00": (442, 443, 444),
    "scene0299_01": (1512,),
}


def load_frames(
    frames_dir,
    frame_ids: Sequence[int],
    resize_hw: Optional[tuple] = (120, 160),
    label_dir: Optional[str] = None,
    label_lut: Optional[np.ndarray] = None,
    label_mapping_tsv=None,
    scan_id: Optional[str] = None,
    exclude: Optional[Sequence[int]] = None,
    skip_bad: bool = True,
) -> Dict[str, np.ndarray]:
    """Load extracted color/depth/pose frames from the SensReader layout
    (color/<id>.jpg, depth/<id>.png uint16 mm, pose/<id>.txt,
    intrinsic/intrinsic_depth.txt) and resize to the training resolution
    (resize_scannet_images.py). With ``label_dir``, also returns per-pixel
    train-id label maps for 2D training.

    Label-id convention: the ``*_2d-label.zip`` pngs (unzip_2d_labels.py)
    carry RAW ScanNet ids that must first be mapped raw→nyu40 via the TSV —
    pass ``label_mapping_tsv`` (path to scannetv2-labels.combined.tsv) for
    those, mirroring scannet_2d.py:86-104. Without it, pngs are assumed to
    already carry nyu40 ids (e.g. scannet_frames_25k), and ids > 40 raise
    rather than silently corrupting supervision.

    Robustness (reference parity: the ``exclude_frames`` blacklist of
    scannet_2d3d.py:53-58 plus preprocess.py:137-140's invalid-pose skip):
    frames in ``exclude`` — defaulting to :data:`EXCLUDE_FRAMES`[scan_id]
    when ``scan_id`` is given — are dropped up front, and with ``skip_bad``
    (default) any frame that fails to decode, has an all-zero depth map, or
    a non-finite pose is skipped with a logged warning instead of poisoning
    the pipeline. The surviving ids are returned as ``out['frame_ids']``;
    an empty survivor set raises."""
    import logging

    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("load_frames: decoding the frames needs PIL (Pillow)") from err

    log = logging.getLogger(__name__)
    frames_dir = Path(frames_dir)
    K = np.loadtxt(frames_dir / "intrinsic" / "intrinsic_depth.txt")[:3, :3]
    if exclude is None and scan_id is not None:
        exclude = EXCLUDE_FRAMES.get(scan_id, ())
    excluded = set(int(e) for e in exclude) if exclude else set()
    rgbs, depths, poses, Ks, labels, kept = [], [], [], [], [], []
    if label_mapping_tsv is not None:
        lut = compose_raw_to_train_lut(parse_label_mapping_tsv(label_mapping_tsv))
    else:
        lut = label_lut if label_lut is not None else nyu40_to_train_ids()
    for fid in frame_ids:
        if int(fid) in excluded:
            log.warning("frame %s excluded by blacklist", fid)
            continue
        try:
            rgb = Image.open(frames_dir / "color" / f"{fid}.jpg")
            dep = Image.open(frames_dir / "depth" / f"{fid}.png")
            k = K.copy()
            if resize_hw is not None:
                h, w = resize_hw
                k[0] *= w / dep.size[0]
                k[1] *= h / dep.size[1]
                rgb = rgb.resize((w, h), Image.BILINEAR)
                dep = dep.resize((w, h), Image.NEAREST)
            rgb_a = np.asarray(rgb, np.float32) / 255.0
            dep_a = np.asarray(dep, np.float32) / 1000.0
            pose = np.loadtxt(frames_dir / "pose" / f"{fid}.txt").astype(np.float32)
            if not np.any(dep_a > 0):
                raise ValueError("depth map is zero everywhere")
            if pose.shape != (4, 4) or not np.all(np.isfinite(pose)):
                raise ValueError("invalid camera pose")
            raw = None
            if label_dir is not None:
                lab = Image.open(Path(label_dir) / f"{fid}.png")
                if resize_hw is not None:
                    lab = lab.resize((resize_hw[1], resize_hw[0]), Image.NEAREST)
                raw = np.asarray(lab, np.int64)
        except Exception as exc:  # corrupt frame: skip-and-log, or re-raise
            if not skip_bad:
                raise
            log.warning("skipping bad frame %s: %s", fid, exc)
            continue
        lab_row = None
        if raw is not None:
            # a systematic id-convention mismatch, not per-frame corruption —
            # always raise (it would silently corrupt ALL supervision)
            if label_mapping_tsv is None and raw.max(initial=0) > 40:
                raise ValueError(
                    f"2D label png {fid}.png carries ids > 40 — these are raw "
                    "ScanNet ids (*_2d-label.zip); pass label_mapping_tsv= so "
                    "they are first mapped raw→nyu40 (scannet_2d.py:86-104)"
                )
            in_range = (raw >= 0) & (raw < len(lut))
            mapped = lut[np.clip(raw, 0, len(lut) - 1)].astype(np.int32)
            lab_row = np.where(in_range, mapped, -1)
        rgbs.append(rgb_a)
        depths.append(dep_a)
        poses.append(pose)
        Ks.append(k.astype(np.float32))
        kept.append(int(fid))
        if lab_row is not None:
            labels.append(lab_row)
    if not kept:
        raise ValueError(
            f"no usable frames among {list(frame_ids)!r} in {frames_dir}"
        )
    out = {
        "rgb": np.stack(rgbs),
        "depth": np.stack(depths),
        "poses": np.stack(poses),
        "intrinsics": np.stack(Ks),
        "frame_ids": np.asarray(kept, np.int64),
    }
    if labels:
        out["label"] = np.stack(labels)
    return out
