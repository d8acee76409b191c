"""Logging + windowed meters: a copy of ``mvkpconv_tpu/training/logger.py``
with the same files and line formats. The logger is named
``"mvkpconv_torch"``, not ``"mvkpconv"``: a process that runs both packages
(the parity tests) would otherwise give one package's messages to a file
handler in the other's run directory.

Replaces common/utils/logger.py (setup_logger) and
common/utils/metric_logger.py (MetricLogger with windowed AverageMeters),
plus the KPConv trainer's ``training.txt`` line format
(utils/trainer.py:128-131,216-225) so plot_convergence-style offline
analysis keeps working on our logs.
"""

from __future__ import annotations

import logging
import sys
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Optional


def setup_logger(name: str = "mvkpconv_torch", output_dir: Optional[str] = None,
                 filename: str = "log.txt") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(output_dir) / filename)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class AverageMeter:
    def __init__(self, window: int = 50):
        self.values = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v: float):
        self.values.append(v)
        self.total += v
        self.count += 1

    @property
    def avg(self) -> float:
        return sum(self.values) / max(len(self.values), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", window: int = 50):
        self.meters = defaultdict(lambda: AverageMeter(window))
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{k}: {m.avg:.4f} ({m.global_avg:.4f})" for k, m in self.meters.items()
        )


class ScalarLog:
    """Append-only ``scalars.jsonl``: one ``{"step", "tag", "value"}`` object
    per line — the TensorBoard-scalars equivalent for this repo (the
    reference logs train/val scalars to TB, mvpnet/train_2d.py:112-117);
    trivially convertible to TB events or pandas."""

    def __init__(self, directory, filename: str = "scalars.jsonl"):
        self.path = Path(directory) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **scalars):
        import json

        with self.path.open("a") as f:
            for tag, value in scalars.items():
                f.write(json.dumps(
                    {"step": int(step), "tag": tag, "value": float(value)}
                ) + "\n")


class ValIoULog:
    """Per-class IoU log, one line per validation — the reference's
    ``val_IoUs.txt`` (utils/trainer.py:445-452), consumed by
    plot_convergence."""

    def __init__(self, directory, filename: str = "val_IoUs.txt"):
        self.path = Path(directory) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def append(self, class_ious):
        with self.path.open("a") as f:
            f.write(" ".join(f"{float(v):.6f}" for v in class_ious) + "\n")


class TrainingLog:
    """Append-only ``training.txt`` in the reference's column format:
    ``epochs steps out_loss offset_loss train_accuracy time``."""

    def __init__(self, directory):
        self.path = Path(directory) / "training.txt"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            self.path.write_text("epochs steps out_loss offset_loss train_accuracy time\n")
        self.t0 = time.time()

    def append(self, epoch: int, step: int, loss: float, offset_loss: float,
               acc: float):
        with self.path.open("a") as f:
            f.write(
                f"{epoch:d} {step:d} {loss:.3f} {offset_loss:.3f} {acc:.3f} "
                f"{time.time() - self.t0:.1f}\n"
            )
