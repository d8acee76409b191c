"""P2: PointNet++'s ball query and 3-NN — wrappers, plain versions, plans, operators.

Port-only kernels, as P1 is: the JAX package's ``ball_query`` and ``knn``
(``mvkpconv_tpu/ops/neighbors.py``) reach no Pallas kernel. d² is the
difference form of the published PointNet++ CUDA ops
(``common.difference_sq_dists``: ((dx² + dy²) + dz²), each step rounded), in
the kernel as in the plain versions, so the two give the same bits.
Contracts:

  * ``ball_query(query, support, r2, k)``: for (B, Nq, 3) queries and
    (B, Ns, 3) supports, (B, Nq, k) int32: the first k supports with
    d² < ``r2`` **in index order**; a row with fewer hits repeats its first
    hit in the empty slots; a row with none holds Ns throughout. ``r2`` is a
    host float (``neighbors.ball_query`` computes it once from the radius).
  * ``three_nn(query, support)``: ((B, Nq, 3) int32 indices, (B, Nq, 3) f32
    d²) of the three smallest (d², index) pairs, ascending: ties go to the
    lower index. With Ns < 3 the missing slots hold index Ns − 1 at d² = inf,
    as ``knn`` pads.

Each is a ``torch.library`` operator (``mvkpconv::ball_query``,
``mvkpconv::three_nn``) whose CPU kernel is the plain version (distance
blocks a chunk of queries at a time) and whose CUDA kernel launches
``csrc/pn2_search.cu``; the fake kernels give the output shapes, so
``torch.export`` keeps each search as one node. :func:`ball_query_plan`
and :func:`three_nn_plan` choose the launch from the shapes alone: the most
queries a CTA (a warp a query for the ball query, a thread a query for the
3-NN) that still give every streaming multiprocessor two CTAs, and a tile
of at most ``MAX_TILE`` supports in shared memory.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mvkpconv_tpu_torch.ops import _build
from mvkpconv_tpu_torch.ops.common import check_devices, check_tensor, difference_sq_dists, query_chunks

MAX_TILE = 1024  # supports a shared-memory tile holds (16 bytes each): csrc/pn2_search.cu kMaxTile
SMS = 132  # the H100's streaming multiprocessors
CTAS_PER_SM = 2  # the plan keeps at least this many CTAs a streaming multiprocessor where it can
BALL_WARPS = (16, 8, 4, 2, 1)  # queries a CTA of the ball query, a warp each, largest first
NN_THREADS = (256, 128, 64, 32)  # queries a CTA of the 3-NN, a thread each, largest first


class Plan(NamedTuple):
    """A launch of ``csrc/pn2_search.cu``: ``queries`` a CTA and ``tile``
    supports a shared-memory tile."""

    queries: int
    tile: int


def _plan(b: int, nq: int, ns: int, choices) -> Plan:
    want = CTAS_PER_SM * SMS
    queries = next((q for q in choices if b * -(-nq // q) >= want), choices[-1])
    return Plan(queries, max(1, min(ns, MAX_TILE)))


def ball_query_plan(b: int, nq: int, ns: int) -> Plan:
    """The ball query's launch for B clouds of ``nq`` queries over ``ns``
    supports: ``queries`` warps a CTA."""
    return _plan(b, nq, ns, BALL_WARPS)


def three_nn_plan(b: int, nq: int, ns: int) -> Plan:
    """The 3-NN's launch: ``queries`` threads a CTA."""
    return _plan(b, nq, ns, NN_THREADS)


def ball_query_plain(query: torch.Tensor, support: torch.Tensor, r2: float, k: int) -> torch.Tensor:
    """Plain PyTorch version: the (B, chunk, Ns) d² block, each hit ranked by
    its index, the k least ranks."""
    b, nq, _ = query.shape
    ns = support.shape[1]
    keff = min(k, ns)
    order = torch.arange(ns, dtype=torch.int32, device=query.device)
    idx = []
    for sl in query_chunks(b, nq, ns):
        d2 = difference_sq_dists(query[:, sl], support)
        ranked = torch.where(d2 < r2, order, ns)
        first = torch.topk(ranked, keff, dim=-1, largest=False, sorted=True).values
        if keff < k:
            first = torch.cat([first, first.new_full((*first.shape[:2], k - keff), ns)], -1)
        idx.append(torch.where(first < ns, first, first[..., :1]))
    return torch.cat(idx, 1)


def three_nn_plain(query: torch.Tensor, support: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the (B, chunk, Ns) d² block, the three least
    int64 keys (d² bits, index) — d² ≥ 0 orders as its bits do, so the key
    orders by d², then by index."""
    b, nq, _ = query.shape
    ns = support.shape[1]
    keff = min(3, ns)
    order = torch.arange(ns, device=query.device)
    idx, vals = [], []
    for sl in query_chunks(b, nq, ns):
        d2 = difference_sq_dists(query[:, sl], support)
        key = (d2.view(torch.int32).to(torch.int64) << 32) | order
        i = torch.topk(key, keff, dim=-1, largest=False, sorted=True).values & 0xFFFFFFFF
        idx.append(i)
        vals.append(torch.gather(d2, -1, i))
    idx, vals = torch.cat(idx, 1), torch.cat(vals, 1)
    if keff < 3:
        idx = torch.cat([idx, idx.new_full((b, nq, 3 - keff), ns - 1)], -1)
        vals = torch.cat([vals, vals.new_full((b, nq, 3 - keff), float("inf"))], -1)
    return idx.to(torch.int32), vals


def check_args(query: torch.Tensor, support: torch.Tensor) -> None:
    """Raise on clouds the CUDA kernels do not take."""
    check_tensor("query", query, torch.float32, 3)
    check_tensor("support", support, torch.float32, 3, device=query.device)
    b, nq, c = query.shape
    if c != 3 or tuple(support.shape[::2]) != (b, 3):
        raise ValueError(f"pn2_search: query {tuple(query.shape)} and support {tuple(support.shape)} "
                         "are not (B, Nq, 3) and (B, Ns, 3)")
    if b > 65535 or b * max(nq, support.shape[1]) * 3 >= 2**31:
        raise ValueError(f"pn2_search: unsupported sizes B={b} Nq={nq} Ns={support.shape[1]}")


torch.library.define("mvkpconv::ball_query", "(Tensor query, Tensor support, float r2, int k) -> Tensor")
torch.library.define("mvkpconv::three_nn", "(Tensor query, Tensor support) -> (Tensor, Tensor)")
ball_query_op = torch.ops.mvkpconv.ball_query.default
three_nn_op = torch.ops.mvkpconv.three_nn.default


def launch_ball_query(query: torch.Tensor, support: torch.Tensor, r2: float, k: int) -> torch.Tensor:
    """Launch ``ball_query_kernel`` on CUDA tensors; a refused launch raises."""
    check_args(query, support)
    if k < 1 or query.shape[0] * query.shape[1] * k >= 2**31:
        raise ValueError(f"ball_query: unsupported k={k} for {tuple(query.shape)}")
    b, nq, _ = query.shape
    ns = support.shape[1]
    pl = ball_query_plan(b, nq, ns)
    out = torch.empty((b, nq, k), dtype=torch.int32, device=query.device)
    _build.launch("mvkp_ball_query", query.device, query.data_ptr(), support.data_ptr(), out.data_ptr(),
                  b, nq, ns, r2, k, pl.queries, pl.tile)
    return out


def launch_three_nn(query: torch.Tensor, support: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``three_nn_kernel`` on CUDA tensors; a refused launch raises."""
    check_args(query, support)
    if support.shape[1] < 1:
        raise ValueError("three_nn: no supports")
    b, nq, _ = query.shape
    ns = support.shape[1]
    pl = three_nn_plan(b, nq, ns)
    idx = torch.empty((b, nq, 3), dtype=torch.int32, device=query.device)
    d2 = torch.empty((b, nq, 3), dtype=torch.float32, device=query.device)
    _build.launch("mvkp_three_nn", query.device, query.data_ptr(), support.data_ptr(), idx.data_ptr(),
                  d2.data_ptr(), b, nq, ns, pl.queries, pl.tile)
    return idx, d2


@torch.library.impl("mvkpconv::ball_query", "cuda")
def _ball_query_cuda(query, support, r2, k):
    """The CUDA kernel of ``mvkpconv::ball_query``."""
    return launch_ball_query(query.float().contiguous(), support.float().contiguous(), r2, k)


@torch.library.impl("mvkpconv::three_nn", "cuda")
def _three_nn_cuda(query, support):
    """The CUDA kernel of ``mvkpconv::three_nn``."""
    return launch_three_nn(query.float().contiguous(), support.float().contiguous())


torch.library.impl("mvkpconv::ball_query", "cpu", ball_query_plain)
torch.library.impl("mvkpconv::three_nn", "cpu", three_nn_plain)


@torch.library.register_fake("mvkpconv::ball_query")
def _ball_query_fake(query, support, r2, k):
    return query.new_empty((query.shape[0], query.shape[1], k), dtype=torch.int32)


@torch.library.register_fake("mvkpconv::three_nn")
def _three_nn_fake(query, support):
    shape = (query.shape[0], query.shape[1], 3)
    return query.new_empty(shape, dtype=torch.int32), query.new_empty(shape, dtype=torch.float32)


def ball_query(query: torch.Tensor, support: torch.Tensor, r2: float, k: int) -> torch.Tensor:
    """The first ``k`` supports with d² < ``r2`` of each query, in index order
    (see the module's contract): the operator ``mvkpconv::ball_query``, the
    plain version on CPU tensors, the kernel on CUDA tensors."""
    check_devices("ball_query", query, support)
    return ball_query_op(query, support, float(r2), int(k))


def three_nn(query: torch.Tensor, support: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three nearest supports of each query and their d², ascending, ties
    to the lower index (see the module's contract): the operator
    ``mvkpconv::three_nn``, the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    check_devices("three_nn", query, support)
    return three_nn_op(query, support)
