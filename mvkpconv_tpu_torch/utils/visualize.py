"""Prediction and potentials clouds as PLY, and the 2D panel as PNG
(``mvkpconv_tpu/utils/visualize.py``: ``labels_to_colors``,
``save_prediction_ply``, ``save_potentials_ply`` with the same bytes for the
same inputs; ``save_2d_panel`` with the same pixels). The JAX package writes
the panel with PIL; the port writes the PNG with the standard library
(``zlib``, ``struct``), so the card's machine needs no imaging package. The
interactive HTML viewer is ``utils/html_viewer.py``."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from mvkpconv_tpu_torch.data.meta import SCANNET_COLOR_PALETTE
from mvkpconv_tpu_torch.utils.ply import write_ply


def labels_to_colors(labels: np.ndarray, ignore_color=(0, 0, 0)) -> np.ndarray:
    """(N,) int labels → (N, 3) uint8 palette colors; ignore (<0) → black."""
    palette = np.asarray(SCANNET_COLOR_PALETTE, np.uint8)
    lab = np.asarray(labels)
    out = palette[np.clip(lab, 0, len(palette) - 1) % len(palette)]
    out = np.where((lab < 0)[:, None], np.asarray(ignore_color, np.uint8), out)
    return out


def save_prediction_ply(
    path,
    points: np.ndarray,
    pred: np.ndarray,
    labels: Optional[np.ndarray] = None,
) -> None:
    """Write a prediction cloud (and ground truth + error mask if given)."""
    fields = [np.asarray(points, np.float32), labels_to_colors(pred),
              np.asarray(pred, np.int32)]
    names = ["x", "y", "z", "red", "green", "blue", "pred"]
    if labels is not None:
        fields.append(np.asarray(labels, np.int32))
        names.append("gt")
        err = ((pred != labels) & (labels >= 0)).astype(np.uint8)
        fields.append(err)
        names.append("error")
    write_ply(path, fields, names)


def save_potentials_ply(path, points: np.ndarray, potentials: np.ndarray) -> None:
    """Voting-coverage debug cloud (tester.py:320-333)."""
    write_ply(
        path,
        [np.asarray(points, np.float32), np.asarray(potentials, np.float32)],
        ["x", "y", "z", "pots"],
    )


def write_png(path, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG: the signature, IHDR,
    one zlib-compressed IDAT of filter-0 scanlines, IEND."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def save_2d_panel(path, image: np.ndarray, gt: np.ndarray, pred: np.ndarray) -> None:
    """Side-by-side (input | ground truth | prediction) PNG panel, the
    reference's TensorBoard image summaries (mvpnet/train_2d.py:209-228).

    Args:
      image: (H, W, 3) float in [0, 1]; gt/pred: (H, W) int train ids.
    """
    img = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
    h, w = img.shape[:2]
    gt_rgb = labels_to_colors(np.asarray(gt).reshape(-1)).reshape(h, w, 3)
    pr_rgb = labels_to_colors(np.asarray(pred).reshape(-1)).reshape(h, w, 3)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_png(path, np.concatenate([img, gt_rgb, pr_rgb], axis=1))
