"""Neighbor search (``mvkpconv_tpu/ops/neighbors.py``).

  * ``radius_neighbors``: up to k nearest supports within a radius, ascending
    by distance, shadow-padded: a thin call into K1's dispatch
    (``ops/kernels/radius_topk.py``), the port's one selection contract for
    the pyramid;
  * ``knn``: the exact k nearest supports, ascending by d²;
  * ``ball_query``: the first k supports inside a radius **in index order**
    (not by distance), short rows padded with the row's first index;
  * ``three_nn``: PointNet++'s 3 nearest supports, ascending by d².

``knn`` reaches no Pallas kernel in the JAX package and runs as plain
PyTorch, a block of queries at a time, on the JAX package's expansion d²
(``common.pairwise_sq_dists``), for the brute-force pixel k-NN's parity with
it. PointNet++'s ``ball_query`` and ``three_nn`` take the difference form of
the published CUDA ops (``common.difference_sq_dists``), a departure from
the JAX package, whose expansion form misplaces supports on a ball's radius
at room coordinates; they are kernel P2 (``ops/kernels/pn2_search.py``) on
the card, their plain versions on the CPU. The two forms conflict, so the
pixel path and PointNet++'s share no selection code. K1 selects by distance,
so it computes none of them. ``pool_and_upsample`` is not ported (it serves
only the neighbor methods the port maps to K1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvkpconv_tpu_torch.ops.common import pairwise_sq_dists, query_chunks
from mvkpconv_tpu_torch.ops.kernels import pn2_search
from mvkpconv_tpu_torch.ops.kernels.pn2_search import three_nn  # noqa: F401
from mvkpconv_tpu_torch.ops.kernels.radius_topk import radius_topk, squared_radius


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


def _smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row, ascending, ties to the lower
    index (as ``lax.top_k`` of −d²): k rounds of argmin and mask-out (k is 3
    where the port calls it)."""
    idx, vals = [], []
    for _ in range(k):
        am = d2.argmin(dim=-1, keepdim=True)
        idx.append(am)
        vals.append(torch.gather(d2, -1, am))
        d2 = d2.scatter(-1, am, float("inf"))
    return torch.cat(idx, -1), torch.cat(vals, -1)


def knn(query: torch.Tensor, support: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest supports of each query with their squared distances.

    Takes (B, Nq, 3) and (B, Ns, 3); returns ((B, Nq, k) int32 indices
    ascending by d², (B, Nq, k) f32 d²), d² in the JAX package's expansion
    form. With k > Ns the rows are padded with index Ns − 1 at d² = inf, as
    in the JAX package.
    """
    b, nq, _ = query.shape
    ns = support.shape[1]
    keff = min(k, ns)
    idx, vals = [], []
    for sl in query_chunks(b, nq, ns):
        i, v = _smallest_k(pairwise_sq_dists(query[:, sl], support), keff)
        idx.append(i)
        vals.append(v)
    idx, vals = torch.cat(idx, 1), torch.cat(vals, 1)
    if keff < k:
        idx = torch.cat([idx, idx.new_full((b, nq, k - keff), ns - 1)], -1)
        vals = torch.cat([vals, vals.new_full((b, nq, k - keff), float("inf"))], -1)
    return idx.to(torch.int32), vals


def ball_query(query: torch.Tensor, support: torch.Tensor, radius: float, k: int) -> torch.Tensor:
    """First k supports with d² < radius² of each query, in index order,
    d² in the difference form (``common.difference_sq_dists``).

    Takes (B, Nq, 3) and (B, Ns, 3); returns (B, Nq, k) int32. A row with
    fewer than k hits repeats its first hit in the empty slots; a row with
    none holds Ns throughout (the reference's oracle asserts hits, and a
    centroid drawn from the supports always hits itself). radius² is the
    float32 square of the float32 radius (``squared_radius``, the bits of
    ``torch.tensor(radius, dtype=torch.float32) ** 2``), a host float handed
    to the operator, so no copy to the card waits for it.
    """
    return pn2_search.ball_query(query, support, squared_radius(radius), k)
