"""K3: segment sum of gather cotangent rows — wrapper, plain version, launch count.

Counterpart of ``mvkpconv_tpu/ops/pallas/segsum.py:banded_window_segsum`` as
``mvkpconv_tpu/ops/gather.py:_transpose_banded`` drives it, without its TPU
machinery (bands, one-hot matmuls, lane packing, the residual scatter): the
sum is exact up to f32 reassociation for any index. Contract: for rows
(B·Nq·K, C) in f32 or bf16 and targets ``index`` (B, Nq, K) in [0, Ns),

    out[b, t, :] = Σ rows[(b, q, k), :] over index[b, q, k] == t,

as (B, Ns, C) float32, the sum accumulated in f32. With ``round_bf16`` f32
rows are first rounded to bf16 (round to nearest even, as
``Tensor.to(torch.bfloat16)``): the gather VJP's ``banded_bf16`` mode hands
its f32 cotangent over as it is, and no cast pass runs.

The CUDA version (``csrc/segsum.cu``) inverts the index first: a plan (CSR
offsets by target and the rows' numbers grouped by target in row order, by a
count, a scan and a stable radix sort) that depends on the index alone.
Whoever makes an index tensor can attach an :class:`IndexPlans` to it
(:func:`attach_plans`; the pyramid does so for each neighbor tensor), and the
gather VJPs that share the tensor then build its plan once, on the first
backward that needs it, and pass it in. Then one kernel sums each target's
rows in a warp (a warp for each group of at most ``GROUP`` 16-byte pieces of
a wide row) and stores the target's row: no atomics on the output, which it
writes whole (zeros included), so the wrapper allocates it uninitialised. A
target with more than ``LONG`` rows is summed in pieces of ``LONG`` rows
whose partial rows the last piece adds up, in piece order. Nothing depends on
the order in which atomics land: the same inputs give the same bits.

CPU tensors take :func:`segsum_plain`; CUDA tensors launch
``csrc/segsum.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from mvkpconv_tpu_torch.ops.common import check_tensor

LONG = 256  # csrc/segsum.cu kLong: most rows one warp sums
GROUP = 8  # csrc/segsum.cu kGroup: most pieces of a row one warp sums


def segsum_plain(rows: torch.Tensor, index: torch.Tensor, ns: int, round_bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the f32 rows (rounded to bf16
    first with ``round_bf16``) into zeros."""
    if round_bf16:
        rows = rows.to(torch.bfloat16)
    b = index.shape[0]
    c = rows.shape[-1]
    base = torch.arange(b, device=index.device, dtype=torch.int64)[:, None, None] * ns
    flat = (index.to(torch.int64) + base).reshape(-1)
    out = torch.zeros((b * ns, c), dtype=torch.float32, device=rows.device)
    return out.index_add_(0, flat, rows.reshape(-1, c).float()).reshape(b, ns, c)


def check_args(rows: torch.Tensor, index: torch.Tensor, ns: int) -> None:
    """Raise on anything the CUDA kernels do not take."""
    check_tensor("rows", rows, (torch.float32, torch.bfloat16), 2)
    check_tensor("index", index, torch.int32, 3, device=rows.device)
    b, nq, k = index.shape
    r, c = rows.shape
    if r != b * nq * k:
        raise ValueError(f"segsum: {r} rows for index {tuple(index.shape)}")
    # 32-bit offsets into the rows, the output, the plan and its scratch
    if ns < 1 or c < 1 or r * c >= 2**31 or b * ns * c >= 2**31 or 2 * b * ns + 5 * r >= 2**31:
        raise ValueError(f"segsum: unsupported sizes B={b} rows={r} Ns={ns} C={c}")


def _sizes(lib, b: int, rows_per_b: int, ns: int, c: int):
    """Ints of the plan, ints of scratch its building takes, 4-byte words of
    scratch a sum at width c takes."""
    from mvkpconv_tpu_torch.ops import _build

    out = (ctypes.c_longlong * 3)()
    _build.check_launch("segsum_sizes", lib.mvkp_segsum_sizes(b, rows_per_b, ns, c, out))
    return int(out[0]), int(out[1]), int(out[2])


def segsum_plan(index: torch.Tensor, ns: int) -> torch.Tensor:
    """The plan of a CUDA ``index`` (B, Nq, K) int32 for ``ns`` targets, built
    by ``csrc/segsum.cu``'s plan kernels: an int32 tensor that any number of
    :func:`segsum` calls on this index may share, at any width."""
    check_tensor("index", index, torch.int32, 3)
    if index.device.type != "cuda":
        raise ValueError(f"segsum_plan: unsupported device {index.device}")
    from mvkpconv_tpu_torch.ops import _build

    lib = _build.library()
    b, nq, k = index.shape
    ints, scratch_ints, _ = _sizes(lib, b, nq * k, ns, 1)
    plan = torch.empty(ints, dtype=torch.int32, device=index.device)
    scratch = torch.empty(scratch_ints, dtype=torch.int32, device=index.device)
    with torch.cuda.device(index.device):
        stream = torch.cuda.current_stream(index.device).cuda_stream
        rc = lib.mvkp_segsum_plan(index.data_ptr(), plan.data_ptr(), scratch.data_ptr(), b, nq * k, ns, stream)
    _build.check_launch("segsum_plan", rc)
    segsum_plan.launches += 1
    return plan


segsum_plan.launches = 0


class IndexPlans:
    """The plans of one index tensor, one for each number of targets it is
    summed into, each built on first use by :func:`segsum_plan`. It holds no
    reference to the tensor, which holds it (``attach_plans``)."""

    def __init__(self):
        self._plans = {}

    def get(self, index: torch.Tensor, ns: int) -> torch.Tensor:
        plan = self._plans.get(ns)
        if plan is None:
            plan = self._plans[ns] = segsum_plan(index, ns)
        return plan


def attach_plans(index: torch.Tensor) -> torch.Tensor:
    """Give an index tensor its :class:`IndexPlans` (as ``index.segsum_plans``),
    which the gather (``ops/gather.py``) hands to :func:`segsum` for every
    VJP on this tensor; returns the tensor."""
    index.segsum_plans = IndexPlans()
    return index


def segsum(rows: torch.Tensor, index: torch.Tensor, ns: int, round_bf16: bool = False,
           plans: IndexPlans | None = None) -> torch.Tensor:
    """(B, Ns, C) f32 segment sums of (B·Nq·K, C) rows by (B, Nq, K) targets;
    ``round_bf16`` rounds f32 rows to bf16 before the sum. On CUDA the plan
    of this index for ``ns`` comes from ``plans`` (the index's
    :class:`IndexPlans`); without them the call builds its own."""
    if rows.device.type == "cpu" and index.device.type == "cpu":
        return segsum_plain(rows, index, ns, round_bf16)
    if rows.device.type != "cuda":
        raise ValueError(f"segsum: unsupported device {rows.device}")
    check_args(rows, index, ns)
    b, nq, k = index.shape
    c = rows.shape[1]
    if nq * k == 0:
        return torch.zeros((b, ns, c), dtype=torch.float32, device=rows.device)
    from mvkpconv_tpu_torch.ops import _build

    lib = _build.library()
    ints, _, words = _sizes(lib, b, nq * k, ns, c)
    plan = segsum_plan(index, ns) if plans is None else plans.get(index, ns)
    if plan.numel() != ints or plan.device != rows.device:
        raise ValueError(f"segsum: a plan of {plan.numel()} ints on {plan.device} is not this index's")
    out = torch.empty((b, ns, c), dtype=torch.float32, device=rows.device)
    scratch = torch.empty(words, dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = lib.mvkp_segsum_sum(
            rows.data_ptr(), int(rows.dtype == torch.bfloat16), int(round_bf16), plan.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, nq * k, ns, c, stream,
        )
    _build.check_launch("segsum", rc)
    segsum.launches += 1
    return out


segsum.launches = 0
