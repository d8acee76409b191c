"""Kernel point dispositions of rigid KPConv: a frozen copy of the port's
repulsion optimisation (``mvkpconv_tpu_torch/models/kernel_points.py``).

One point at the centre and the rest on the shell of radius 0.66 of the unit
ball, spread by the Thomson problem's tangential repulsion from 8 random
starts (numpy seed 42), the start with the widest least spacing kept. The
result for 15 points is stored in ``kernel_points_15.json``, so that a run
does not pay the optimisation; ``portbench/tests`` recomputes it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TABLE = Path(__file__).resolve().parent / "kernel_points_{}.json"


def optimize(num_points: int) -> np.ndarray:
    """(num_points, 3) float32 unit dispositions."""
    rng = np.random.RandomState(42)
    rng.uniform(-1, 1, size=(num_points, 3))  # the original's start, overwritten below

    def thomson(shell):
        step = 0.05
        for _ in range(3000):
            diff = shell[:, None, :] - shell[None, :, :]
            d = np.linalg.norm(diff, axis=-1)
            np.fill_diagonal(d, 1.0)
            grad = np.sum(diff / (d**3)[..., None], axis=1)
            grad -= np.sum(grad * shell, axis=-1, keepdims=True) * shell
            shell += step * grad / max(np.linalg.norm(grad, axis=-1).max(), 1e-9)
            shell /= np.linalg.norm(shell, axis=-1, keepdims=True)
            step *= 0.999
        return shell

    def min_dist(shell):
        d = np.linalg.norm(shell[:, None] - shell[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min()

    best = None
    for _ in range(8):
        init = rng.randn(num_points - 1, 3)
        init /= np.linalg.norm(init, axis=-1, keepdims=True)
        cand = thomson(init)
        if best is None or min_dist(cand) > min_dist(best):
            best = cand
    pts = np.zeros((num_points, 3))
    pts[1:] = best * 0.66
    return pts.astype(np.float32)


def unit_dispositions(num_points: int) -> np.ndarray:
    """The stored table for ``num_points``, or the optimisation where none is
    stored."""
    path = Path(str(TABLE).format(num_points))
    if path.is_file():
        return np.asarray(json.loads(path.read_text()), np.float32)
    return optimize(num_points)


def kernel_points(radius: float, num_points: int) -> np.ndarray:
    """Dispositions scaled to ``radius`` (f32 times the radius, as the
    program scales them)."""
    return (unit_dispositions(num_points) * radius).astype(np.float32)
