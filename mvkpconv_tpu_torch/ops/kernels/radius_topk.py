"""K1: exact radius top-k selection — wrapper, plain version, operator.

Counterpart of ``mvkpconv_tpu/ops/pallas/radius_topk.py:binmin_radius_topk``
without its approximations (bins, 2⁻⁹ distance keys, the Ns ≤ 2¹⁴ limit).
Contract (that of ``radius_neighbors``): for (B, Nq, 3) queries and
(B, Ns, 3) supports, the up-to-k supports with d² < r² in ascending
(d², index) order, missing slots = Ns, as (B, Nq, k) int32. d² is the f32
difference form ((dx² + dy²) + dz², each step rounded), r² the f32 square of
the f32 radius.

Shadow query rows (at SHADOW_COORD) are at d² = 0 from shadow support rows
and select them; valid rows never see padding (it is out of every radius).

:func:`radius_topk` calls the ``torch.library`` operator
``mvkpconv::radius_topk`` (``radius_topk_op``), whose CPU kernel is
:func:`radius_topk_plain` and whose CUDA kernel launches
``csrc/radius_topk.cu``; its fake kernel gives the output's shape, so
``torch.export`` keeps the operator whole in an exported program. It is
defined with ``torch.library.define`` / ``impl`` rather than ``custom_op``,
whose Python wrapper adds host time to every call.

The kernel skips groups of 32 consecutive supports (and super-groups of 32
groups) whose bounding box lies out of the query's radius;
:func:`group_boxes` and :func:`box_lower_bound` are that
test's arithmetic in PyTorch, operation by operation, so that the CPU tests
can hold it: the bound never exceeds the rounded d² of a pair it covers.
"""

from __future__ import annotations

import numpy as np
import torch

from mvkpconv_tpu_torch.ops import _build
from mvkpconv_tpu_torch.ops.common import check_devices, check_tensor

K_MAX = 128  # the kernel's largest list capacity
GROUP = 32  # csrc/radius_topk.cu kGroup: supports per box
SUPER = 32  # csrc/radius_topk.cu kSuper: boxes per super-group box
_INF_BITS = 0x7F800000  # float32 +inf


def squared_radius(radius: float) -> float:
    """r² as the float32 square of the float32 radius."""
    r = np.float32(radius)
    return float(r * r)


def radius_topk_plain(
    query: torch.Tensor, support: torch.Tensor, radius: float, k: int,
    budget: int = 1 << 23,
) -> torch.Tensor:
    """Plain PyTorch version, chunked over queries (≤ ``budget`` pairs live).

    Ties break by index through a composite int64 key (d² bits, index):
    d² ≥ 0, so its float bits order like its value.
    """
    b, nq, _ = query.shape
    ns = support.shape[1]
    r2 = torch.tensor(squared_radius(radius), dtype=torch.float32, device=query.device)
    keff = min(k, ns)
    chunk = max(1, budget // max(1, b * ns))
    idx_s = torch.arange(ns, dtype=torch.int64, device=query.device)
    inf_key = _INF_BITS << 32
    outs = []
    for s in range(0, nq, chunk):
        diff = query[:, s:s + chunk, None, :] - support[:, None, :, :]
        d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + (
            diff[..., 2] * diff[..., 2]
        )
        key = (d2.view(torch.int32).to(torch.int64) << 32) | idx_s
        key = torch.where(d2 < r2, key, torch.full_like(key, inf_key))
        top = torch.topk(key, keff, dim=-1, largest=False, sorted=True).values
        outs.append(torch.where(top < inf_key, top & 0xFFFFFFFF, torch.full_like(top, ns)))
    idx = torch.cat(outs, dim=1).to(torch.int32)
    if keff < k:
        idx = torch.cat([idx, idx.new_full((b, nq, k - keff), ns)], dim=-1)
    return idx


def group_boxes(points: torch.Tensor, group: int = GROUP):
    """(lo, hi), each (B, ceil(N / group), 3): the bounding boxes of runs of
    ``group`` consecutive points, the last run over the points it has. Taken
    from the data, whatever its order; applied to ``lo`` and ``hi`` in turn
    it gives the super-group boxes."""
    b, n, _ = points.shape
    pad = -n % group
    if pad:
        # a slot past the end repeats its run's first point, as the kernel's lanes do
        first = points[:, n - (n % group)][:, None, :].expand(b, pad, 3)
        points = torch.cat([points, first], dim=1)
    runs = points.reshape(b, -1, group, 3)
    return runs.amin(dim=2), runs.amax(dim=2)


def box_lower_bound(q_lo, q_hi, s_lo, s_hi) -> torch.Tensor:
    """A lower bound of the rounded d² between any point of the box
    [q_lo, q_hi] and any point of the box [s_lo, s_hi] (…, 3 each, broadcast;
    a point is the box with lo = hi): the kernel skips a group iff this is
    ≥ r². Per axis the gap max(s_lo − q_hi, q_lo − s_hi, 0) never exceeds the
    rounded |q − s| (f32 subtraction is monotone and symmetric), and the
    squares and sums are those of d², in its order, monotone in each
    non-negative argument."""
    gap = torch.maximum(torch.maximum(s_lo - q_hi, q_lo - s_hi), torch.zeros_like(s_lo))
    return (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]


def check_args(query: torch.Tensor, support: torch.Tensor, k: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    check_tensor("query", query, torch.float32, 3)
    check_tensor("support", support, torch.float32, 3, device=query.device)
    b, nq, c = query.shape
    if c != 3 or support.shape[2] != 3 or support.shape[0] != b:
        raise ValueError(
            f"radius_topk: query {tuple(query.shape)} / support "
            f"{tuple(support.shape)} are not (B, Nq, 3) / (B, Ns, 3)"
        )
    ns = support.shape[1]
    if not 1 <= k <= K_MAX:
        raise ValueError(f"radius_topk: k={k} outside [1, {K_MAX}]")
    if ns < 1 or max(nq, ns) * b * 3 >= 2**31 or b * nq * k >= 2**31:
        raise ValueError(f"radius_topk: unsupported sizes B={b} Nq={nq} Ns={ns}")


torch.library.define("mvkpconv::radius_topk", "(Tensor query, Tensor support, float radius, int k) -> Tensor")
radius_topk_op = torch.ops.mvkpconv.radius_topk.default


@torch.library.impl("mvkpconv::radius_topk", "cuda")
def _radius_topk_cuda(query, support, radius, k):
    """The CUDA kernel of ``mvkpconv::radius_topk``."""
    check_args(query, support, k)
    b, nq, _ = query.shape
    ns = support.shape[1]
    out = torch.empty((b, nq, k), dtype=torch.int32, device=query.device)
    # scratch of the box pre-pass, in float4s: the packed supports, a (lo, hi)
    # pair per group and per super-group
    groups = -(-ns // GROUP)
    supers = -(-groups // SUPER)
    scratch = torch.empty((b * (ns + 2 * groups + 2 * supers), 4), dtype=torch.float32,
                          device=query.device)
    boxes, super_boxes = scratch[b * ns:], scratch[b * (ns + 2 * groups):]
    _build.launch("mvkp_radius_topk", query.device, query.data_ptr(), support.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), boxes.data_ptr(), super_boxes.data_ptr(), b, nq, ns, squared_radius(radius), k)
    return out


torch.library.impl("mvkpconv::radius_topk", "cpu", radius_topk_plain)


@torch.library.register_fake("mvkpconv::radius_topk")
def _radius_topk_fake(query, support, radius, k):
    return query.new_empty((query.shape[0], query.shape[1], k), dtype=torch.int32)


def radius_topk(
    query: torch.Tensor, support: torch.Tensor, radius: float, k: int
) -> torch.Tensor:
    """Up-to-k nearest supports within ``radius``, ascending, shadow = Ns:
    the operator ``mvkpconv::radius_topk``, the plain version on CPU
    tensors, the kernel on CUDA tensors (any other device raises)."""
    check_devices("radius_topk", query, support)
    return radius_topk_op(query, support, float(radius), int(k))
