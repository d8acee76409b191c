"""Radius neighbor search (``mvkpconv_tpu/ops/neighbors.py:radius_neighbors``).

One selection contract for the whole port: this is a thin call into K1's
dispatch (``ops/kernels/radius_topk.py``). ``knn``, ``ball_query`` and
``pool_and_upsample`` are not ported yet.
"""

from __future__ import annotations

import torch

from mvkpconv_tpu_torch.ops.kernels.radius_topk import radius_topk


def radius_neighbors(
    query: torch.Tensor, support: torch.Tensor, radius: float, k: int
) -> torch.Tensor:
    """Up-to-k nearest neighbors within ``radius``, shadow-padded.

    Takes (Nq, 3)/(Ns, 3) or (B, Nq, 3)/(B, Ns, 3); returns (..., Nq, k)
    int32 ascending by distance, entries equal to Ns meaning "no neighbor".
    """
    if query.dim() == 2:
        return radius_topk(query[None], support[None], radius, k)[0]
    if query.dim() != 3:
        raise ValueError(f"expected rank 2 or 3 points, got {query.dim()}")
    return radius_topk(query, support, radius, k)
