"""P1: farthest point sampling — wrapper, plain version, launch count.

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
and whose CUDA kernel launches ``csrc/fps.cu`` (one block a cloud, the
whole loop on the device); its fake kernel gives the output's shape, so
``torch.export`` keeps the loop as one operator instead of unrolling it.
Defined with ``torch.library.define`` / ``impl``, as K1 is.
"""

from __future__ import annotations

from typing import Optional

import torch

from mvkpconv_tpu_torch.ops.common import check_tensor

REGISTER_POINTS = 8 * 1024  # csrc/fps.cu: above this the minima live in a scratch array


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


@torch.library.impl("mvkpconv::farthest_point_sample", "cuda")
def _fps_cuda(points, num_samples, mask):
    """The CUDA kernel of ``mvkpconv::farthest_point_sample``."""
    points = points.float().contiguous()
    mask = None if mask is None else mask.contiguous()
    check_args(points, num_samples, mask)
    b, n, _ = points.shape
    from mvkpconv_tpu_torch.ops import _build

    lib = _build.library()
    out = torch.empty((b, num_samples), dtype=torch.int32, device=points.device)
    scratch = (torch.empty((b, n), dtype=torch.float32, device=points.device)
               if n > REGISTER_POINTS else None)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        rc = lib.mvkp_fps(
            points.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, n, num_samples, stream,
        )
    _build.check_launch("farthest_point_sample", rc)
    farthest_point_sample.launches += 1
    return out


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
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"farthest_point_sample: unsupported device {points.device}")
    return fps_op(points, int(num_samples), mask)


farthest_point_sample.launches = 0  # calls that reached the kernel
