"""Prediction and potentials clouds as PLY (``mvkpconv_tpu/utils/visualize.py``:
``labels_to_colors``, ``save_prediction_ply``, ``save_potentials_ply``; the
same bytes for the same inputs). The 2D panel (``save_2d_panel``, PIL) and
the HTML viewer serve tools not ported yet (ROADMAP queue 1, item 8)."""

from __future__ import annotations

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
