"""On-device multiscale input pyramid (``mvkpconv_tpu/ops/pyramid.py``).

Level conventions (as in the JAX package):
  * level ``l`` cell size  dl_l = first_subsampling_dl · 2^l
  * conv radius            r_l  = dl_l · conv_radius
  * points_{l+1} = grid_subsample(points_l, dl_{l+1})
  * conv neighbors: radius r_l within level l           (K = conv_neighbors[l])
  * pool neighbors: radius r_l, queries level l+1, supports level l
  * upsample: 1-NN from level l queries into level l+1, within 2·r_l
All index tensors use the shadow convention (index == N_support ⇒ no
neighbor ⇒ zero feature row). Every selection — conv, pool and the k=1
upsample — goes through kernel K1, which is exact and has no support-count
limit, so the JAX package's CPU / oversize fallbacks have no counterpart.
Each index tensor carries the plans of its gather VJP's segment sum (K3,
``ops/kernels/segsum.py:attach_plans``), built on the first backward that
needs them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mvkpconv_tpu_torch import tracing
from mvkpconv_tpu_torch.ops.kernels.segsum import attach_plans
from mvkpconv_tpu_torch.ops.neighbors import radius_neighbors
from mvkpconv_tpu_torch.ops.sampling import grid_subsample


def num_layers_from_architecture(architecture: Sequence[str]) -> int:
    """Number of pyramid levels implied by a block list."""
    layers = 1
    for block in architecture:
        if "upsample" in block or "global" in block:
            break
        if "pool" in block or "strided" in block:
            layers += 1
    return layers


def deform_flags_from_architecture(architecture: Sequence[str]):
    """(conv_flags, pool_flags) per level: conv widened if any deformable
    block convolves at the level; pool widened iff the strided block itself
    is deformable."""
    conv_flags, pool_flags = [], []
    layer_blocks = []
    for block in architecture:
        if "upsample" in block or "global" in block:
            break
        if not ("pool" in block or "strided" in block):
            layer_blocks.append(block)
            continue
        conv_flags.append(any("deform" in b for b in layer_blocks))
        pool_flags.append("deform" in block)
        layer_blocks = []
    conv_flags.append(any("deform" in b for b in layer_blocks))
    return tuple(conv_flags), tuple(pool_flags)


DEFAULT_CONV_NEIGHBORS = (34, 34, 34, 34, 34)
DEFAULT_POOL_NEIGHBORS = (34, 34, 34, 34)


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static shape/geometry contract between data pipeline and model."""

    num_points: Tuple[int, ...]
    first_subsampling_dl: float = 0.04
    conv_radius: float = 2.5
    deform_radius: float = 6.0
    conv_neighbors: Tuple[int, ...] = DEFAULT_CONV_NEIGHBORS
    pool_neighbors: Tuple[int, ...] = DEFAULT_POOL_NEIGHBORS
    deform_conv_levels: Tuple[bool, ...] = ()
    deform_pool_levels: Tuple[bool, ...] = ()
    deform_conv_neighbors: Optional[Tuple[int, ...]] = None
    deform_pool_neighbors: Optional[Tuple[int, ...]] = None
    # accepted for configuration parity; every method runs K1 here
    neighbor_method: str = "exact"

    @property
    def num_levels(self) -> int:
        return len(self.num_points)

    def cell_size(self, level: int) -> float:
        return self.first_subsampling_dl * (2.0**level)

    def _deform(self, flags, level: int) -> bool:
        return bool(flags) and level < len(flags) and flags[level]

    def radius(self, level: int) -> float:
        """Conv-neighbor radius at ``level``."""
        mult = (
            self.deform_radius
            if self._deform(self.deform_conv_levels, level)
            else self.conv_radius
        )
        return self.cell_size(level) * mult

    def pool_radius(self, level: int) -> float:
        """Pool-neighbor radius at ``level`` (queries = level+1)."""
        mult = (
            self.deform_radius
            if self._deform(self.deform_pool_levels, level)
            else self.conv_radius
        )
        return self.cell_size(level) * mult

    def conv_k(self, level: int) -> int:
        if (
            self._deform(self.deform_conv_levels, level)
            and self.deform_conv_neighbors is not None
        ):
            return self.deform_conv_neighbors[level]
        return self.conv_neighbors[level]

    def pool_k(self, level: int) -> int:
        if (
            self._deform(self.deform_pool_levels, level)
            and self.deform_pool_neighbors is not None
        ):
            return self.deform_pool_neighbors[level]
        return self.pool_neighbors[level]

    @staticmethod
    def for_architecture(
        architecture: Sequence[str],
        num_points0: int,
        first_subsampling_dl: float = 0.04,
        conv_radius: float = 2.5,
        deform_radius: float = 6.0,
        conv_neighbors: Optional[Tuple[int, ...]] = None,
        pool_neighbors: Optional[Tuple[int, ...]] = None,
        subsample_ratio: float = 4.0,
    ) -> "PyramidSpec":
        """Budgets derived from a block list: point budgets shrink by
        ``subsample_ratio`` a level (at least 8), neighbor budgets default
        to 34, and the deformable levels come from the block names."""
        levels = num_layers_from_architecture(architecture)
        pts, n = [], num_points0
        for _ in range(levels):
            pts.append(max(int(n), 8))
            n = n / subsample_ratio
        conv_flags, pool_flags = deform_flags_from_architecture(architecture)
        return PyramidSpec(
            num_points=tuple(pts),
            first_subsampling_dl=first_subsampling_dl,
            conv_radius=conv_radius,
            deform_radius=deform_radius,
            conv_neighbors=conv_neighbors or DEFAULT_CONV_NEIGHBORS[:levels],
            pool_neighbors=pool_neighbors or DEFAULT_POOL_NEIGHBORS[: levels - 1],
            deform_conv_levels=conv_flags,
            deform_pool_levels=pool_flags,
        )


class Pyramid(NamedTuple):
    """All per-level tensors a KPFCNN forward needs."""

    points: Tuple[torch.Tensor, ...]  # (B, N_l, 3), invalid at SHADOW_COORD
    masks: Tuple[torch.Tensor, ...]  # (B, N_l) bool
    neighbors: Tuple[torch.Tensor, ...]  # (B, N_l, Kc_l) int32, shadow = N_l
    pools: Tuple[torch.Tensor, ...]  # (B, N_{l+1}, Kp_l) int32, shadow = N_l
    upsamples: Tuple[torch.Tensor, ...]  # (B, N_l, 1) int32 into level l+1


def build_pyramid(
    points: torch.Tensor, mask: torch.Tensor, spec: PyramidSpec
) -> Pyramid:
    """Build the full input pyramid on ``points.device``.

    Args:
      points: (B, N0, 3) float32, grid-subsampled at ``first_subsampling_dl``
        by the data pipeline and padded to N0.
      mask: (B, N0) validity.
      spec: static geometry/budget contract.
    """
    if points.shape[1] != spec.num_points[0]:
        raise ValueError(
            f"level-0 budget mismatch: points {points.shape[1]} vs spec "
            f"{spec.num_points[0]}"
        )
    with tracing.span("pyramid"):
        pts, msks = [points], [mask]
        neighbors, pools, upsamples = [], [], []
        for level in range(spec.num_levels):
            p, m = pts[level], msks[level]
            with tracing.span("pyramid.neighbors", level, m):
                neighbors.append(
                    radius_neighbors(p, p, spec.radius(level), spec.conv_k(level))
                )
            if level + 1 < spec.num_levels:
                with tracing.span("pyramid.subsample", level + 1):
                    sub = grid_subsample(
                        p, spec.cell_size(level + 1), spec.num_points[level + 1], mask=m
                    )
                pts.append(sub.points)
                msks.append(sub.mask)
                rp = spec.pool_radius(level)
                with tracing.span("pyramid.neighbors", level + 1, sub.mask):
                    pools.append(radius_neighbors(sub.points, p, rp, spec.pool_k(level)))
                # upsample: 1-NN into level l+1 within 2× the POOL radius
                with tracing.span("pyramid.neighbors", level, m):
                    upsamples.append(radius_neighbors(p, sub.points, 2.0 * rp, 1))
        return Pyramid(
            points=tuple(pts),
            masks=tuple(msks),
            neighbors=tuple(map(attach_plans, neighbors)),
            pools=tuple(map(attach_plans, pools)),
            upsamples=tuple(map(attach_plans, upsamples)),
        )
