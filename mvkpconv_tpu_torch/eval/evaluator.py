"""Whole-dataset segmentation evaluator: a copy of
``mvkpconv_tpu/eval/evaluator.py`` on the port's ``training/metrics.py``.

Replaces mvpnet/evaluate_3d.py:11-93 (Evaluator: running confusion, overall/
class accuracy + IoU, class table) and the IoU bookkeeping in
KPConv-PyTorch/utils/tester.py:259-318.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from mvkpconv_tpu_torch.data.meta import CLASS_NAMES
from mvkpconv_tpu_torch.training.metrics import accuracy_from_confusion, iou_from_confusion


class Evaluator:
    def __init__(self, class_names: Sequence[str] = CLASS_NAMES, ignore_label: int = -1):
        self.class_names = tuple(class_names)
        self.num_classes = len(self.class_names)
        self.ignore_label = ignore_label
        self.confusion = np.zeros((self.num_classes, self.num_classes), np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray):
        pred = np.asarray(pred).ravel()
        label = np.asarray(label).ravel()
        valid = label != self.ignore_label
        idx = label[valid] * self.num_classes + np.clip(pred[valid], 0, self.num_classes - 1)
        self.confusion += np.bincount(
            idx, minlength=self.num_classes**2
        ).reshape(self.num_classes, self.num_classes)

    @property
    def class_iou(self) -> np.ndarray:
        return iou_from_confusion(self.confusion)

    @property
    def miou(self) -> float:
        return float(self.class_iou.mean())

    @property
    def overall_accuracy(self) -> float:
        return accuracy_from_confusion(self.confusion)

    @property
    def class_accuracy(self) -> np.ndarray:
        row = self.confusion.sum(1)
        return np.divide(
            np.diag(self.confusion), np.maximum(row, 1), dtype=np.float64
        )

    def table(self) -> str:
        """Per-class tsv table like evaluate_3d.py:71-93."""
        lines = ["class\tiou\taccuracy"]
        iou, acc = self.class_iou, self.class_accuracy
        for i, name in enumerate(self.class_names):
            lines.append(f"{name}\t{iou[i]:.4f}\t{acc[i]:.4f}")
        lines.append(f"mean\t{self.miou:.4f}\t{self.overall_accuracy:.4f}")
        return "\n".join(lines)
