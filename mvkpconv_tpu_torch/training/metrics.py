"""Segmentation metrics: confusion matrices, IoU, accuracy
(``mvkpconv_tpu/training/metrics.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def confusion_matrix(
    pred: torch.Tensor,
    label: torch.Tensor,
    num_classes: int,
    mask: Optional[torch.Tensor] = None,
    ignore_label: int = -1,
) -> torch.Tensor:
    """(C, C) int64 confusion with rows = true, cols = pred (bincount trick)."""
    valid = label != ignore_label
    if mask is not None:
        valid = valid & mask
    idx = label.clamp(min=0).long() * num_classes + pred.long().clamp(0, num_classes - 1)
    flat = torch.where(valid.reshape(-1), idx.reshape(-1), num_classes * num_classes)
    counts = torch.bincount(flat, minlength=num_classes * num_classes + 1)[:-1]
    return counts.reshape(num_classes, num_classes)


def iou_from_confusion(conf) -> np.ndarray:
    """Per-class IoU; absent classes get the present-class mIoU placeholder
    so they don't skew averages."""
    conf = np.asarray(conf, np.float64)
    tp = np.diag(conf)
    fp = conf.sum(0) - tp
    fn = conf.sum(1) - tp
    denom = tp + fp + fn
    present = denom > 0
    iou = np.zeros_like(tp)
    iou[present] = tp[present] / denom[present]
    if present.any():
        iou[~present] = iou[present].mean()
    return iou


def accuracy_from_confusion(conf) -> float:
    conf = np.asarray(conf, np.float64)
    return float(np.diag(conf).sum() / max(conf.sum(), 1.0))


def rescale_confusion_to_proportions(conf, true_proportions) -> np.ndarray:
    """Rescale confusion rows so each true class carries its proportion of
    the full clouds (sphere sampling over-samples some classes)."""
    conf = np.asarray(conf, np.float64)
    row = conf.sum(1)
    scale = np.where(row > 0, np.asarray(true_proportions, np.float64) / np.maximum(row, 1e-9), 0.0)
    return conf * scale[:, None]
