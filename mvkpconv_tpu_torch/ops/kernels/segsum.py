"""K3: segment sum of gather cotangent rows — wrapper, plain version, launch count.

Counterpart of ``mvkpconv_tpu/ops/pallas/segsum.py:banded_window_segsum`` as
``mvkpconv_tpu/ops/gather.py:_transpose_banded`` drives it, without its TPU
machinery (bands, one-hot matmuls, lane packing, the residual scatter): the
sum is exact up to f32 reassociation for any index. Contract: for rows
(B·Nq·K, C) in f32 or bf16 and targets ``index`` (B, Nq, K) in [0, Ns),

    out[b, t, :] = Σ rows[(b, q, k), :] over index[b, q, k] == t,

as (B, Ns, C) float32, the sum accumulated in f32.

Rows aimed at the last source row (the shadow row of ``pad_shadow_row``
callers, which every short neighbor list and padded query points at) are
summed per block in the kernel's shared memory, so that hot address takes
one atomic per block and channel, not one per row.

CPU tensors take :func:`segsum_plain`; CUDA tensors launch
``csrc/segsum.cu`` or raise.
"""

from __future__ import annotations

import torch

from mvkpconv_tpu_torch.ops.common import check_tensor

MAX_C = 12288  # csrc/segsum.cu kMaxC: 48 KB of shared memory per block


def segsum_plain(rows: torch.Tensor, index: torch.Tensor, ns: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the f32 rows into zeros."""
    b = index.shape[0]
    c = rows.shape[-1]
    base = torch.arange(b, device=index.device, dtype=torch.int64)[:, None, None] * ns
    flat = (index.to(torch.int64) + base).reshape(-1)
    out = torch.zeros((b * ns, c), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, flat, rows.reshape(-1, c).float()).reshape(b, ns, c)


def check_args(rows: torch.Tensor, index: torch.Tensor, ns: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    check_tensor("rows", rows, (torch.float32, torch.bfloat16), 2)
    check_tensor("index", index, torch.int32, 3, device=rows.device)
    b, nq, k = index.shape
    r, c = rows.shape
    if r != b * nq * k:
        raise ValueError(f"segsum: {r} rows for index {tuple(index.shape)}")
    # c floats of shared memory per block hold the shadow row's partial sums
    if ns < 1 or not 1 <= c <= MAX_C or b > 65535 or r * c >= 2**31 or b * ns * c >= 2**31:
        raise ValueError(f"segsum: unsupported sizes B={b} rows={r} Ns={ns} C={c}")


def segsum(rows: torch.Tensor, index: torch.Tensor, ns: int) -> torch.Tensor:
    """(B, Ns, C) f32 segment sums of (B·Nq·K, C) rows by (B, Nq, K) targets."""
    if rows.device.type == "cpu" and index.device.type == "cpu":
        return segsum_plain(rows, index, ns)
    if rows.device.type != "cuda":
        raise ValueError(f"segsum: unsupported device {rows.device}")
    check_args(rows, index, ns)
    b, nq, k = index.shape
    c = rows.shape[1]
    from mvkpconv_tpu_torch.ops import _build

    lib = _build.library()
    out = torch.zeros((b, ns, c), dtype=torch.float32, device=rows.device)
    if nq * k:
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            rc = lib.mvkp_segsum(
                rows.data_ptr(), int(rows.dtype == torch.bfloat16), index.data_ptr(),
                out.data_ptr(), b, nq * k, ns, c, stream,
            )
        _build.check_launch("segsum", rc)
        segsum.launches += 1
    return out


segsum.launches = 0
