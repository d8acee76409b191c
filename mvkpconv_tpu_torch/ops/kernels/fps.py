"""P1: farthest point sampling — wrapper, plain version, plan, operator.

A port-only kernel: the JAX package's FPS (``mvkpconv_tpu/ops/sampling.py:
farthest_point_sample``) is a ``lax.fori_loop``, no Pallas kernel. Contract:
for (B, N, 3) points, (B, num_samples) int32 centroid indices; the first is
index 0; each next one maximizes the least d² to the chosen set, ties to
the lowest index (``argmax``); points with a False ``mask`` are never picked
while a valid point remains; with ``num_samples > N`` every point is taken
once, then every distance is 0 and index 0 repeats, as in the JAX package.
d² is ((dx² + dy²) + dz²), each step rounded.

:func:`farthest_point_sample` calls the ``torch.library`` operator
``mvkpconv::farthest_point_sample`` (``fps_op``), whose CPU kernel is
:func:`farthest_point_sample_plain` (an eager loop of one step a centroid)
and whose CUDA kernel launches ``csrc/fps.cu``; its fake kernel gives the
output's shape, so ``torch.export`` keeps the loop as one operator instead
of unrolling it. Defined with ``torch.library.define`` / ``impl``, as K1 is.

The kernel spreads a cloud over a thread-block cluster of C CTAs, C in
{1, 2, 4, 8}. Ownership is by index: CTA rank r owns the r-th contiguous
range of ceil(N / C) points, and within it each thread a contiguous run of
at most 8 points, kept in registers. A step has one exchange and one
barrier: each warp's winner is stored into every CTA's shared memory through
distributed shared memory (``st.async``), and each CTA's transaction
mbarrier completes once all of them have landed (``__syncthreads`` where
C = 1). The largest d² wins, a tie the lowest index; every warp reduces all
the winners, so each thread knows the next centroid without a second
barrier. :func:`plan` picks C, the threads a CTA and the points a thread
from N alone; above 8 × 1024 × 8 points (``REGISTER_POINTS``) the minima
live in a scratch array (``points == 0``). ``INSTANCES`` lists the (C,
points a thread) pairs the kernel is built for, which are those ``plan``
gives; :func:`launch` takes any plan of them (:func:`layout`) and raises on
another.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from mvkpconv_tpu_torch.ops import _build
from mvkpconv_tpu_torch.ops.common import check_devices, check_tensor

CLUSTER_SIZES = (1, 2, 4, 8)  # the portable cluster sizes
MAX_THREADS = 1024
MAX_POINTS = 8  # points a thread in registers
REGISTER_POINTS = CLUSTER_SIZES[-1] * MAX_THREADS * MAX_POINTS  # above this: the scratch array
CTA_POINTS = 1024  # the plan adds CTAs to a cluster until each owns at most this many
CTA_THREADS = 128  # then the fewest points a thread that keep a CTA at most this wide
# (CTAs a cluster, points a thread) of each instance of csrc/fps.cu's kernel:
# plan() gives one CTA up to CTA_POINTS points (any points a thread), else
# 8 points a thread (or, above REGISTER_POINTS, the scratch array: 0)
INSTANCES = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 8), (4, 8), (8, 8), (8, 0))


class Plan(NamedTuple):
    """How ``csrc/fps.cu`` lays out a cloud of ``n`` points: a cluster of
    ``clusters`` CTAs of ``threads`` threads, each thread holding ``points``
    points in registers (0: the minima in a scratch array)."""

    n: int
    clusters: int
    threads: int
    points: int

    @property
    def span(self) -> int:
        """Points a CTA owns (the last may own fewer)."""
        return -(-self.n // self.clusters)

    def ranges(self) -> List[Tuple[int, int]]:
        """Each rank's [start, stop) of point indices, in rank order."""
        return [(min(r * self.span, self.n), min((r + 1) * self.span, self.n)) for r in range(self.clusters)]

    def warp_starts(self) -> List[int]:
        """The first index of each warp's run of points, over every rank, in
        index order (a rank's first warp starts at its range)."""
        run = 32 * self.points if self.points else -(-self.span // (self.threads // 32))
        return [i for lo, hi in self.ranges() for i in range(lo, hi, run)]


def layout(n: int, clusters: int, points: int) -> Plan:
    """The plan of ``clusters`` CTAs with ``points`` points a thread for
    clouds of ``n`` points: the fewest threads that cover a CTA's range
    (``MAX_THREADS`` for the scratch array, ``points == 0``)."""
    span = -(-n // clusters)
    threads = MAX_THREADS if points == 0 else -(-span // (points * 32)) * 32
    return Plan(n, clusters, threads, points)


def plan(n: int) -> Plan:
    """The kernel's plan for clouds of ``n`` points: CTAs until each owns at
    most ``CTA_POINTS`` (at most 8), then the fewest points a thread (up to
    8) that keep a CTA at ``CTA_THREADS`` threads or fewer."""
    if n < 1:
        raise ValueError(f"farthest_point_sample: no plan for N={n}")
    clusters = CLUSTER_SIZES[0]
    while clusters < CLUSTER_SIZES[-1] and clusters * CTA_POINTS < n:
        clusters *= 2
    span = -(-n // clusters)
    if span > MAX_THREADS * MAX_POINTS:
        return layout(n, clusters, 0)
    points = 1
    while points < MAX_POINTS and points * CTA_THREADS < span:
        points *= 2
    return layout(n, clusters, points)


def check_plan(pl: Plan, n: int) -> None:
    """Raise unless ``pl`` is a plan for ``n`` points of a built instance."""
    if (pl.n != n or (pl.clusters, pl.points) not in INSTANCES or pl.threads % 32
            or not 32 <= pl.threads <= MAX_THREADS or pl.threads * pl.points < pl.span * (pl.points > 0)):
        raise ValueError(f"farthest_point_sample: {pl} is no plan of a built instance for N={n}")


def farthest_point_sample_plain(
    points: torch.Tensor, num_samples: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version: one step a centroid."""
    b, n, _ = points.shape
    p = points.float()
    out = torch.zeros((b, num_samples), dtype=torch.int64, device=points.device)
    min_d2 = torch.full((b, n), float("inf"), device=points.device)
    cur = torch.zeros((b, 1), dtype=torch.int64, device=points.device)
    for i in range(1, num_samples):
        diff = p - torch.gather(p, 1, cur[..., None].expand(b, 1, 3))
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        cand = min_d2 if mask is None else min_d2.masked_fill(~mask, float("-inf"))
        cur = cand.argmax(dim=1, keepdim=True)
        out[:, i:i + 1] = cur
    return out.to(torch.int32)


def check_args(points: torch.Tensor, num_samples: int, mask: Optional[torch.Tensor]) -> None:
    """Raise on anything the CUDA kernel does not take."""
    check_tensor("points", points, torch.float32, 3)
    b, n, c = points.shape
    if c != 3 or n < 1:
        raise ValueError(f"farthest_point_sample: points {tuple(points.shape)} are not (B, N >= 1, 3)")
    if mask is not None:
        check_tensor("mask", mask, torch.bool, 2, device=points.device)
        if tuple(mask.shape) != (b, n):
            raise ValueError(f"farthest_point_sample: mask {tuple(mask.shape)} is not {(b, n)}")
    if num_samples < 0 or b * n * 3 >= 2**31 or b * num_samples >= 2**31:
        raise ValueError(f"farthest_point_sample: unsupported sizes B={b} N={n} S={num_samples}")


torch.library.define("mvkpconv::farthest_point_sample", "(Tensor points, int num_samples, Tensor? mask) -> Tensor")
fps_op = torch.ops.mvkpconv.farthest_point_sample.default


def launch(points: torch.Tensor, num_samples: int, mask: Optional[torch.Tensor],
           pl: Optional[Plan] = None) -> torch.Tensor:
    """Launch ``csrc/fps.cu`` on CUDA tensors under the plan ``pl`` (by
    default ``plan(N)``, else one of ``INSTANCES``: see :func:`layout`); a
    refused launch, or a cluster the card cannot place, raises."""
    check_args(points, num_samples, mask)
    b, n, _ = points.shape
    pl = pl or plan(n)
    check_plan(pl, n)
    out = torch.empty((b, num_samples), dtype=torch.int32, device=points.device)
    scratch = torch.empty((b, n), dtype=torch.float32, device=points.device) if pl.points == 0 else None
    _build.launch("mvkp_fps", points.device, points.data_ptr(), None if mask is None else mask.data_ptr(),
                  out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, n, num_samples,
                  pl.clusters, pl.threads, pl.points)
    return out


@torch.library.impl("mvkpconv::farthest_point_sample", "cuda")
def _fps_cuda(points, num_samples, mask):
    """The CUDA kernel of ``mvkpconv::farthest_point_sample``."""
    return launch(points.float().contiguous(), num_samples, None if mask is None else mask.contiguous())


torch.library.impl("mvkpconv::farthest_point_sample", "cpu", farthest_point_sample_plain)


@torch.library.register_fake("mvkpconv::farthest_point_sample")
def _fps_fake(points, num_samples, mask):
    return points.new_empty((points.shape[0], num_samples), dtype=torch.int32)


def farthest_point_sample(
    points: torch.Tensor, num_samples: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Farthest point sampling of (B, N, 3) points → (B, num_samples) int32:
    the operator ``mvkpconv::farthest_point_sample``, the plain version on
    CPU tensors, the kernel on CUDA tensors (any other device raises)."""
    check_devices("farthest_point_sample", points, mask)
    return fps_op(points, int(num_samples), mask)
