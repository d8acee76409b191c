"""K2: projective pixel k-NN selection — wrapper, plain version, operator.

Counterpart of ``mvkpconv_tpu/ops/pallas/pixel_select.py:pixel_topk_indices``
without its 2⁻¹⁴ distance quantization. For each point, the k nearest of its
V·window² candidate pixels: view v's window starts at (iv0, iu0)[b, v, n].
Slot order is view-major, then row-major in the window
(``v·window² + dv·window + du``) and ties go to the lower slot. d² is
computed in f32 from the f32 point and the candidate as stored (f32 or
bf16), in the difference form ((dx² + dy²) + dz², each step rounded). The
winners come back as flat indices ``(iv0+dv)·W + iu0+du + v·H·W`` into the
V·H·W pixel axis, (B, N, k) int32.

:func:`pixel_topk` calls the ``torch.library`` operator
``mvkpconv::pixel_topk``, whose CPU kernel is :func:`pixel_topk_plain` (k
rounds of argmin and mask-out, the JAX package's ``minext`` algorithm) and
whose CUDA kernel launches ``csrc/pixel_select.cu``; its fake kernel gives
the output's shape for ``torch.export``.
"""

from __future__ import annotations

import torch

from mvkpconv_tpu_torch.ops import _build
from mvkpconv_tpu_torch.ops.common import check_devices, check_tensor
from mvkpconv_tpu_torch.ops.gather import group_points

K_MAX = 32  # the kernel's largest list capacity


def candidate_indices(iu0, iv0, h: int, w: int, window: int) -> torch.Tensor:
    """Flat V·H·W index of every candidate slot, (B, N, V·window²) int64."""
    b, v, n = iu0.shape
    ar = torch.arange(window * window, device=iu0.device)
    dv, du = ar // window, ar % window
    view_base = (torch.arange(v, device=iu0.device) * (h * w))[None, :, None, None]
    gi = (iv0.long()[..., None] + dv) * w + (iu0.long()[..., None] + du) + view_base
    return gi.permute(0, 2, 1, 3).reshape(b, n, v * window * window)


def pixel_topk_plain(points, image_xyz, iu0, iv0, window: int, k: int):
    """Plain PyTorch version: gather the candidates, d², k argmin rounds."""
    b, v, h, w, _ = image_xyz.shape
    gi = candidate_indices(iu0, iv0, h, w, window)
    cand = group_points(image_xyz.reshape(b, v * h * w, 3), gi)
    diff = cand.float() - points[:, :, None, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + (
        diff[..., 2] * diff[..., 2]
    )
    outs = []
    for _ in range(k):
        am = torch.argmin(d2, dim=-1, keepdim=True)  # first minimum: lower slot
        outs.append(torch.gather(gi, -1, am))
        d2 = d2.scatter(-1, am, float("inf"))
    return torch.cat(outs, dim=-1).to(torch.int32)


def check_args(points, image_xyz, iu0, iv0, window: int, k: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    dev = points.device
    check_tensor("points", points, torch.float32, 3)
    check_tensor("image_xyz", image_xyz, (torch.float32, torch.bfloat16), 5, device=dev)
    check_tensor("iu0", iu0, torch.int32, 3, device=dev)
    check_tensor("iv0", iv0, torch.int32, 3, device=dev)
    b, v, h, w, c = image_xyz.shape
    n = points.shape[1]
    if (
        c != 3 or points.shape != (b, n, 3) or iu0.shape != (b, v, n)
        or iv0.shape != (b, v, n)
    ):
        raise ValueError(
            f"pixel_topk: points {tuple(points.shape)}, image_xyz "
            f"{tuple(image_xyz.shape)}, iu0 {tuple(iu0.shape)}, iv0 "
            f"{tuple(iv0.shape)} do not match (B,N,3)/(B,V,H,W,3)/(B,V,N)"
        )
    if not 1 <= window <= min(h, w) or not 1 <= k <= min(K_MAX, v * window * window):
        raise ValueError(f"pixel_topk: window={window} / k={k} unsupported (k ≤ {K_MAX})")
    if b * v * h * w * 3 >= 2**31 or b * n * k >= 2**31:
        raise ValueError("pixel_topk: tensors too large for 32-bit offsets")


torch.library.define(
    "mvkpconv::pixel_topk",
    "(Tensor points, Tensor image_xyz, Tensor iu0, Tensor iv0, int window, int k) -> Tensor",
)
pixel_topk_op = torch.ops.mvkpconv.pixel_topk.default


@torch.library.impl("mvkpconv::pixel_topk", "cuda")
def _pixel_topk_cuda(points, image_xyz, iu0, iv0, window, k):
    """The CUDA kernel of ``mvkpconv::pixel_topk``."""
    check_args(points, image_xyz, iu0, iv0, window, k)
    dev = points.device
    b, v, h, w, _ = image_xyz.shape
    n = points.shape[1]
    out = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    _build.launch("mvkp_pixel_topk", dev, points.data_ptr(), image_xyz.data_ptr(),
                  int(image_xyz.dtype == torch.bfloat16), iu0.data_ptr(), iv0.data_ptr(), out.data_ptr(),
                  b, n, v, h, w, window, k)
    return out


torch.library.impl("mvkpconv::pixel_topk", "cpu", pixel_topk_plain)


@torch.library.register_fake("mvkpconv::pixel_topk")
def _pixel_topk_fake(points, image_xyz, iu0, iv0, window, k):
    return points.new_empty((points.shape[0], points.shape[1], k), dtype=torch.int32)


def pixel_topk(
    points: torch.Tensor,
    image_xyz: torch.Tensor,
    iu0: torch.Tensor,
    iv0: torch.Tensor,
    window: int,
    k: int,
) -> torch.Tensor:
    """Flat V·H·W indices of the k nearest candidate pixels per point: the
    operator ``mvkpconv::pixel_topk``.

    Args:
      points: (B, N, 3) float32.
      image_xyz: (B, V, H, W, 3) float32 or bfloat16 pixel positions.
      iu0, iv0: (B, V, N) int32 window corners, in bounds.
      window: window side; k: neighbors (k ≤ V·window²).
    """
    v = image_xyz.shape[1]
    if not 1 <= k <= v * window * window:
        raise ValueError(f"pixel_topk: k={k} outside [1, V·window²={v * window * window}]")
    check_devices("pixel_topk", points, image_xyz, iu0, iv0)
    return pixel_topk_op(points, image_xyz, iu0, iv0, int(window), int(k))
