"""K1: exact radius top-k selection — wrapper, plain version, launch count.

Counterpart of ``mvkpconv_tpu/ops/pallas/radius_topk.py:binmin_radius_topk``
without its approximations (bins, 2⁻⁹ distance keys, the Ns ≤ 2¹⁴ limit).
Contract (that of ``radius_neighbors``): for (B, Nq, 3) queries and
(B, Ns, 3) supports, the up-to-k supports with d² < r² in ascending
(d², index) order, missing slots = Ns, as (B, Nq, k) int32. d² is the f32
difference form ((dx² + dy²) + dz², each step rounded), r² the f32 square of
the f32 radius.

Shadow query rows (at SHADOW_COORD) are at d² = 0 from shadow support rows
and select them; valid rows never see padding (it is out of every radius).

CPU tensors take :func:`radius_topk_plain`; CUDA tensors launch
``csrc/radius_topk.cu`` or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from mvkpconv_tpu_torch.ops.common import check_tensor

K_MAX = 128  # the kernel's largest list capacity
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


def radius_topk(
    query: torch.Tensor, support: torch.Tensor, radius: float, k: int
) -> torch.Tensor:
    """Up-to-k nearest supports within ``radius``, ascending, shadow = Ns."""
    if query.device.type == "cpu" and support.device.type == "cpu":
        return radius_topk_plain(query, support, radius, k)
    if query.device.type != "cuda":
        raise ValueError(f"radius_topk: unsupported device {query.device}")
    check_args(query, support, k)
    b, nq, _ = query.shape
    ns = support.shape[1]
    from mvkpconv_tpu_torch.ops import _build

    lib = _build.library()
    out = torch.empty((b, nq, k), dtype=torch.int32, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        rc = lib.mvkp_radius_topk(
            query.data_ptr(), support.data_ptr(), out.data_ptr(),
            b, nq, ns, squared_radius(radius), k, stream,
        )
    _build.check_launch("radius_topk", rc)
    radius_topk.launches += 1
    return out


radius_topk.launches = 0
