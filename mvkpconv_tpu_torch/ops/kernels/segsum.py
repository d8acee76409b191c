"""K3: segment sum of gather cotangent rows — wrappers, plain versions, operators.

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

Both steps are ``torch.library`` operators: ``mvkpconv::segsum_plan``
(CPU kernel :func:`segsum_plan_plain`, the plan's layout in PyTorch) and
``mvkpconv::segsum``, which takes the plan as a tensor (CPU kernel
:func:`segsum_plain`, which needs no plan); their CUDA kernels launch
``csrc/segsum.cu`` and their fake kernels give the output's shape.
"""

from __future__ import annotations

import ctypes

import torch

from mvkpconv_tpu_torch.ops import _build
from mvkpconv_tpu_torch.ops.common import check_devices, check_tensor

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


def plan_layout(m: int, n: int):
    """Offsets in the int32 plan of ``m`` targets and ``n`` rows
    (``csrc/segsum.cu`` ``layout``): counts at 0, then ``start`` (m + 1 CSR
    offsets), ``n_pieces``, ``order`` (n row numbers), ``pieces`` (int4s),
    and the plan's ``total`` ints."""
    max_pieces = 2 * (n // LONG) + 2
    start = -(-m // 4) * 4
    order = start + m + 2
    pieces = -(-(order + n) // 4) * 4
    return {"start": start, "n_pieces": start + m + 1, "order": order, "pieces": pieces,
            "total": pieces + 4 * max_pieces}


def segsum_plan_plain(index: torch.Tensor, ns: int) -> torch.Tensor:
    """Plain PyTorch version of the plan: for targets b·Ns + t (rows whose t
    is out of range last), each target's rows counted, their CSR offsets,
    the rows' numbers grouped by target in row order (a stable sort), and a
    {target, piece, first piece's number, pieces} entry for each piece of
    ``LONG`` rows of a target of more than ``LONG``. Ints the kernels leave
    unwritten are 0 here."""
    b = index.shape[0]
    m = b * ns
    t = index.reshape(b, -1).to(torch.int64)
    base = torch.arange(b, dtype=torch.int64, device=index.device)[:, None] * ns
    key = torch.where((t >= 0) & (t < ns), t + base, m).reshape(-1)
    counts = torch.bincount(key, minlength=m + 1)[:m]
    long = torch.nonzero(counts > LONG)[:, 0]
    per = -(-counts[long] // LONG)
    first = torch.cumsum(per, 0) - per
    piece = torch.arange(int(per.sum()), device=index.device) - first.repeat_interleave(per)
    pieces = torch.stack([long.repeat_interleave(per), piece, first.repeat_interleave(per),
                          per.repeat_interleave(per)], 1)
    lay = plan_layout(m, key.numel())
    plan = torch.zeros(lay["total"], dtype=torch.int64, device=index.device)
    plan[:m] = counts
    plan[lay["start"] + 1:lay["start"] + m + 1] = torch.cumsum(counts, 0)
    plan[lay["n_pieces"]] = pieces.shape[0]
    plan[lay["order"]:lay["order"] + key.numel()] = torch.sort(key, stable=True).indices
    plan[lay["pieces"]:lay["pieces"] + pieces.numel()] = pieces.reshape(-1)
    return plan.to(torch.int32)


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


def _sizes(b: int, rows_per_b: int, ns: int, c: int):
    """Ints of the plan, ints of scratch its building takes, 4-byte words of
    scratch a sum at width c takes."""
    out = (ctypes.c_longlong * 3)()
    _build.check_launch("segsum_sizes", _build.library().mvkp_segsum_sizes(b, rows_per_b, ns, c, out))
    return int(out[0]), int(out[1]), int(out[2])


torch.library.define("mvkpconv::segsum_plan", "(Tensor index, int ns) -> Tensor")
torch.library.define("mvkpconv::segsum", "(Tensor rows, Tensor index, Tensor plan, int ns, bool round_bf16) -> Tensor")
segsum_plan_op = torch.ops.mvkpconv.segsum_plan.default
segsum_op = torch.ops.mvkpconv.segsum.default


@torch.library.impl("mvkpconv::segsum_plan", "cuda")
def _segsum_plan_cuda(index, ns):
    """The CUDA kernel of ``mvkpconv::segsum_plan``: ``csrc/segsum.cu``'s plan kernels."""
    check_tensor("index", index, torch.int32, 3)
    b, nq, k = index.shape
    ints, scratch_ints, _ = _sizes(b, nq * k, ns, 1)
    plan = torch.empty(ints, dtype=torch.int32, device=index.device)
    scratch = torch.empty(scratch_ints, dtype=torch.int32, device=index.device)
    _build.launch("mvkp_segsum_plan", index.device, index.data_ptr(), plan.data_ptr(), scratch.data_ptr(),
                  b, nq * k, ns)
    return plan


@torch.library.impl("mvkpconv::segsum", "cuda")
def _segsum_cuda(rows, index, plan, ns, round_bf16):
    """The CUDA kernel of ``mvkpconv::segsum``: ``csrc/segsum.cu``'s sum."""
    check_args(rows, index, ns)
    b, nq, k = index.shape
    c = rows.shape[1]
    ints, _, words = _sizes(b, nq * k, ns, c)
    check_tensor("plan", plan, torch.int32, 1, device=rows.device)
    if plan.numel() != ints:
        raise ValueError(f"segsum: a plan of {plan.numel()} ints is not this index's")
    out = torch.empty((b, ns, c), dtype=torch.float32, device=rows.device)
    scratch = torch.empty(words, dtype=torch.float32, device=rows.device)
    _build.launch("mvkp_segsum_sum", rows.device, rows.data_ptr(), int(rows.dtype == torch.bfloat16),
                  int(round_bf16), plan.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, nq * k, ns, c)
    return out


torch.library.impl("mvkpconv::segsum_plan", "cpu", segsum_plan_plain)


@torch.library.impl("mvkpconv::segsum", "cpu")
def _segsum_cpu(rows, index, plan, ns, round_bf16):
    """The CPU kernel of ``mvkpconv::segsum``: the plain version, which reads no plan."""
    return segsum_plain(rows, index, ns, round_bf16)


@torch.library.register_fake("mvkpconv::segsum_plan")
def _segsum_plan_fake(index, ns):
    return index.new_empty(plan_layout(index.shape[0] * ns, index.numel())["total"], dtype=torch.int32)


@torch.library.register_fake("mvkpconv::segsum")
def _segsum_fake(rows, index, plan, ns, round_bf16):
    return rows.new_empty((index.shape[0], ns, rows.shape[-1]), dtype=torch.float32)


def segsum_plan(index: torch.Tensor, ns: int) -> torch.Tensor:
    """The plan of an ``index`` (B, Nq, K) int32 for ``ns`` targets: the
    operator ``mvkpconv::segsum_plan``, an int32 tensor that any number of
    :func:`segsum` calls on this index may share, at any width."""
    check_devices("segsum_plan", index)
    return segsum_plan_op(index, int(ns))


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
    ``round_bf16`` rounds f32 rows to bf16 before the sum: the operator
    ``mvkpconv::segsum``, with the plan of this index for ``ns`` from
    ``plans`` (the index's :class:`IndexPlans`); without them the call
    builds its own."""
    check_devices("segsum", rows, index)
    if index.numel() == 0:
        return torch.zeros((index.shape[0], ns, rows.shape[-1]), dtype=torch.float32, device=rows.device)
    plan = segsum_plan(index, ns) if plans is None else plans.get(index, ns)
    return segsum_op(rows, index, plan, int(ns), bool(round_bf16))
