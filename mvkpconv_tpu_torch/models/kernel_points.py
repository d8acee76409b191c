"""Kernel point dispositions for KPConv (numpy only).

A copy of ``mvkpconv_tpu/models/kernel_points.py``, which the port cannot
import without jax (importing anything under ``mvkpconv_tpu`` imports its
ops package). A test pins the two to the same output. Dispositions come
from a deterministic numpy repulsion optimization: one point at the center
and the rest on a shell at radius 0.66, scaled to the kernel radius.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _optimize_dispositions(num_points: int, dimension: int = 3) -> np.ndarray:
    """Repulsion-optimized points in the unit ball, first point at origin."""
    rng = np.random.RandomState(42)
    # over-generate then keep: simple projected gradient descent on the
    # pairwise 1/r repulsive energy with a weak centering force.
    pts = rng.uniform(-1, 1, size=(num_points, dimension))
    pts[0] = 0.0
    radius0 = 1.0
    step = 0.1
    for it in range(10000):
        diff = pts[:, None, :] - pts[None, :, :]  # (K, K, D)
        d = np.linalg.norm(diff, axis=-1)
        np.fill_diagonal(d, 1.0)
        # gradient of sum 1/d : -diff / d^3 (repulsion pushes apart)
        grad = np.sum(diff / (d**3)[..., None], axis=1)
        # attractive force toward the center keeps the cloud bounded
        grad -= 2.0 * pts * num_points * 0.18
        gnorm = np.linalg.norm(grad, axis=-1, keepdims=True)
        pts += step * grad / np.maximum(gnorm, 1e-9) * 0.01
        pts[0] = 0.0
        # keep inside unit ball
        norms = np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True), 1e-9)
        pts = np.where(norms > radius0, pts / norms * radius0, pts)
        if it % 1000 == 999:
            step *= 0.8
    # The equilibrium for center-fixed kernels is one center + a spherical
    # shell (the reference's k_015_center_3D.ply has all non-center points at
    # radius 0.661). Project to the shell and refine tangentially (Thomson
    # problem) for uniform angular spacing.
    n_shell = num_points - 1

    def thomson(shell):
        step = 0.05
        for _ in range(3000):
            diff = shell[:, None, :] - shell[None, :, :]
            d = np.linalg.norm(diff, axis=-1)
            np.fill_diagonal(d, 1.0)
            grad = np.sum(diff / (d**3)[..., None], axis=1)
            # tangential component only
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
    for restart in range(8):
        init = rng.randn(n_shell, dimension)
        init /= np.linalg.norm(init, axis=-1, keepdims=True)
        cand = thomson(init)
        if best is None or min_dist(cand) > min_dist(best):
            best = cand
    pts[1:] = best * 0.66
    return pts.astype(np.float32)


def _random_rotation(rng: np.random.RandomState, vertical_only: bool) -> np.ndarray:
    theta = rng.rand() * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    if vertical_only:
        return rz
    # random axis-angle rotation
    u = rng.randn(3)
    u /= np.linalg.norm(u)
    alpha = rng.rand() * 2 * np.pi
    K = np.array(
        [[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]], np.float32
    )
    return (np.eye(3) + np.sin(alpha) * K + (1 - np.cos(alpha)) * K @ K).astype(
        np.float32
    )


def kernel_point_positions(
    radius: float,
    num_points: int = 15,
    dimension: int = 3,
    randomize: bool = False,
    seed: int = 0,
    fixed: str = "center",
) -> np.ndarray:
    """Kernel point layout scaled to ``radius`` (= KP_extent-scaled radius).

    Args:
      radius: target kernel radius (the KPConv op passes KP_extent-derived
        radius, matching load_kernels' ``radius`` argument).
      num_points: K (reference default 15).
      randomize: apply a random rotation + 0.01·radius jitter like the
        reference load path.
      seed: RNG seed for the randomization.
      fixed: 'center' pins point 0 at the origin (only supported mode).

    Returns:
      (num_points, dimension) float32.
    """
    assert fixed == "center", "only center-fixed kernels are supported"
    pts = _optimize_dispositions(num_points, dimension).copy()
    if randomize:
        rng = np.random.RandomState(seed)
        pts = pts + rng.normal(scale=0.01, size=pts.shape)
        pts = pts @ _random_rotation(rng, vertical_only=False).T
    return (pts * radius).astype(np.float32)
