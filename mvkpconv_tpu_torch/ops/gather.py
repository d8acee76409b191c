"""Neighbor-feature gathers and their VJP (``mvkpconv_tpu/ops/gather.py``).

``group_points`` folds the batch into the row axis and gathers with one flat
``index_select``. Its backward, the segment sum of the cotangent rows by
target row, follows the gather-transpose mode in scope when the FORWARD ran
(:func:`gather_transpose`, like the JAX scope, kept per call in the
autograd context, so nothing is read back at backward time):

  * ``scatter``: ``index_add_`` into zeros in the cotangent's dtype (JAX's
    native take-transpose, ``_transpose_scatter``);
  * ``banded``: kernel K3 (``ops/kernels/segsum.py``) on the rows, f32 (a
    bf16 cotangent stays bf16, as in JAX), accumulated in f32;
  * ``banded_bf16``: the rows rounded to bf16 (RNE, JAX's
    ``ct.astype(jnp.bfloat16)``), then K3 with f32 accumulation; an f32
    cotangent goes to K3 as it is, with ``round_bf16``, which rounds it in
    registers (no cast pass).

On CUDA K3 needs a plan of the index. An index tensor that carries
``segsum_plans`` (``ops/kernels/segsum.py:attach_plans``; every neighbor
tensor of the pyramid) builds it once for all the VJPs on that tensor; any
other index builds one for its call.

Every mode casts the result to the features' dtype. ``group_points_joint``
is the counterpart of ``group_points_packed``: one gather of pixel xyz ⊕
features with the same indices (the JAX package packs bf16 pairs into f32
lanes for the TPU's gather; the port gathers an f32 payload and hands back
each part in its own dtype, which is exact). Its backward is autograd's
scatter in every mode, as JAX's is two plain scatter-adds.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Tuple

import torch

from mvkpconv_tpu_torch.ops.kernels.segsum import segsum

TRANSPOSE_MODES = ("scatter", "banded", "banded_bf16")

_MODE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "gather_transpose", default="scatter"
)


@contextlib.contextmanager
def gather_transpose(mode: str):
    """Scope the VJP mode of the ``group_points`` calls whose forward runs
    inside."""
    if mode not in TRANSPOSE_MODES:
        raise ValueError(f"unknown gather transpose mode {mode!r}")
    token = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(token)


def _check(features: torch.Tensor, index: torch.Tensor) -> None:
    if index.dim() != 3 or features.dim() != 3 or index.shape[0] != features.shape[0]:
        raise ValueError(
            f"batch dims mismatch: features {tuple(features.shape)} "
            f"index {tuple(index.shape)}"
        )


def _flat_index(index: torch.Tensor, ns: int) -> torch.Tensor:
    base = torch.arange(index.shape[0], device=index.device, dtype=torch.int64)[:, None, None] * ns
    return (index.to(torch.int64) + base).reshape(-1)


def _gather_rows(features: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    b, ns, c = features.shape
    _, nq, k = index.shape
    return features.reshape(b * ns, c).index_select(0, _flat_index(index, ns)).reshape(b, nq, k, c)


class _GroupPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, index, mode):
        ctx.mode = mode
        ctx.feat_shape = features.shape
        ctx.feat_dtype = features.dtype
        ctx.save_for_backward(index)
        # the plans the index's maker attached (segsum.attach_plans), if any
        ctx.plans = getattr(index, "segsum_plans", None)
        return _gather_rows(features, index)

    @staticmethod
    def backward(ctx, ct):
        (index,) = ctx.saved_tensors
        b, ns, c = ctx.feat_shape
        rows = ct.reshape(-1, c)
        if ctx.mode == "scatter":
            d = torch.zeros((b * ns, c), dtype=ct.dtype, device=ct.device)
            d = d.index_add_(0, _flat_index(index, ns), rows).reshape(b, ns, c)
        else:
            # banded_bf16 hands f32 rows over as they are: K3 rounds them
            round_bf16 = ctx.mode == "banded_bf16" and rows.dtype == torch.float32
            if rows.dtype != torch.bfloat16 and not round_bf16:
                rows = rows.to(torch.bfloat16 if ctx.mode == "banded_bf16" else torch.float32)
            d = segsum(rows.contiguous(), index.to(torch.int32).contiguous(), ns, round_bf16, ctx.plans)
        return d.to(ctx.feat_dtype), None, None


def group_points(features: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather (B, Ns, C) features at (B, Nq, K) indices → (B, Nq, K, C).

    Shadow indices (== Ns) need a zero row at Ns: see :func:`pad_shadow_row`.
    Differentiable in ``features``, with the VJP mode in scope now.
    """
    _check(features, index)
    return _GroupPoints.apply(features, index, _MODE.get())


def group_points_joint(
    xyz: torch.Tensor, feat: torch.Tensor, index: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gather for positions ⊕ features at the same indices.

    Returns (gathered xyz (B, Nq, K, 3) f32, gathered feat (B, Nq, K, C) in
    ``feat.dtype``).
    """
    payload = torch.cat([xyz.float(), feat.float()], dim=-1)
    _check(payload, index)
    rows = _gather_rows(payload, index)
    return rows[..., :3], rows[..., 3:].to(feat.dtype)


def pad_shadow_row(features: torch.Tensor) -> torch.Tensor:
    """Append a zero row on the point axis so shadow index Ns selects zeros."""
    return torch.cat([features, features.new_zeros(features[..., :1, :].shape)], dim=-2)


def batch_index_select(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Select rows of (B, N, C) by (B, M) indices → (B, M, C)."""
    return torch.gather(
        values, -2, index.to(torch.int64)[..., None].expand(*index.shape, values.shape[-1])
    )
