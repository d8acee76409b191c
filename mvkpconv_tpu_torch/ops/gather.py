"""Neighbor-feature gathers, forward only (``mvkpconv_tpu/ops/gather.py``).

``group_points`` folds the batch into the row axis and gathers with one flat
``index_select``. ``group_points_joint`` is the counterpart of
``group_points_packed``: one gather of pixel xyz ⊕ features with the same
indices (the JAX package packs bf16 pairs into f32 lanes for the TPU's
gather; the port gathers an f32 payload and hands back each part in its
own dtype, which is exact). Backward (autograd ``index_add_``, then kernel
K3) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def group_points(features: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Gather (B, Ns, C) features at (B, Nq, K) indices → (B, Nq, K, C).

    Shadow indices (== Ns) need a zero row at Ns: see :func:`pad_shadow_row`.
    """
    if index.dim() != 3 or features.dim() != 3 or index.shape[0] != features.shape[0]:
        raise ValueError(
            f"batch dims mismatch: features {tuple(features.shape)} "
            f"index {tuple(index.shape)}"
        )
    b, ns, c = features.shape
    _, nq, k = index.shape
    base = torch.arange(b, device=index.device, dtype=torch.int64)[:, None, None] * ns
    flat = (index.to(torch.int64) + base).reshape(-1)
    return features.reshape(b * ns, c).index_select(0, flat).reshape(b, nq, k, c)


def group_points_joint(
    xyz: torch.Tensor, feat: torch.Tensor, index: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gather for positions ⊕ features at the same indices.

    Returns (gathered xyz (B, Nq, K, 3) f32, gathered feat (B, Nq, K, C) in
    ``feat.dtype``).
    """
    payload = torch.cat([xyz.float(), feat.float()], dim=-1)
    rows = group_points(payload, index)
    return rows[..., :3], rows[..., 3:].to(feat.dtype)


def pad_shadow_row(features: torch.Tensor) -> torch.Tensor:
    """Append a zero row on the point axis so shadow index Ns selects zeros."""
    return torch.cat([features, features.new_zeros(features[..., :1, :].shape)], dim=-2)


def batch_index_select(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Select rows of (B, N, C) by (B, M) indices → (B, M, C)."""
    return torch.gather(
        values, -2, index.to(torch.int64)[..., None].expand(*index.shape, values.shape[-1])
    )
