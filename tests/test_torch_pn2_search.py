"""PyTorch port: P2, PointNet++'s ball query and 3-NN as operators
(``mvkpconv::ball_query``, ``mvkpconv::three_nn``; ``ops/kernels/pn2_search.py``).

  * Through the operators, on small clouds at room coordinates, against a
    numpy oracle of the contract (the difference-form d², each step rounded
    in float32): the ball query takes the first k supports with d² < r² in
    index order, a support exactly on the radius (d² == r²) is out and one
    ulp inside is in, a short row repeats its first hit, a row with none
    holds Ns, fewer supports than k pad as a short row; the 3-NN takes the
    three least (d², index) pairs with the d² bits, exact ties go to the
    lower index, Ns < 3 pads with Ns − 1 at inf; supports over several of the
    kernel's shared-memory tiles. On a CUDA host the same cases also hold
    the kernel to the plain version bit for bit; without one they skip.
  * ``neighbors.ball_query`` hands the operator the float32 square of the
    float32 radius as a host float.
  * The launch plans come from the shapes alone; the fake kernels give the
    real shapes, and ``torch.export`` keeps each search as one node; the
    wrappers refuse what the kernels do not take; both launch counters are
    in ``tracing.launch_counts()``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mvkpconv_tpu_torch import tracing
from mvkpconv_tpu_torch.ops import _build, neighbors
from mvkpconv_tpu_torch.ops.kernels import pn2_search as p2
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

ROOM = np.array([3.1, 5.7, 1.3], np.float32)  # clouds at room coordinates: the subtraction rounds
DEVICES = ["cpu", "cuda"]


def device_of(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only there")
    return torch.device(name)


def d2_np(q, s):
    """(B, Nq, Ns) float32 d² in the difference form, each step rounded."""
    d = q[:, :, None, :] - s[:, None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def ball_query_np(q, s, r2, k):
    d2 = d2_np(q, s)
    b, nq, ns = d2.shape
    out = np.full((b, nq, k), ns, np.int32)
    for bb in range(b):
        for i in range(nq):
            hits = np.flatnonzero(d2[bb, i] < np.float32(r2))[:k]
            if len(hits):
                out[bb, i] = hits[0]
                out[bb, i, :len(hits)] = hits
    return out


def three_nn_np(q, s):
    d2 = d2_np(q, s)
    b, nq, ns = d2.shape
    idx = np.full((b, nq, 3), ns - 1, np.int32)
    val = np.full((b, nq, 3), np.inf, np.float32)
    for bb in range(b):
        for i in range(nq):
            order = np.lexsort((np.arange(ns), d2[bb, i]))[:3]
            idx[bb, i, :len(order)] = order
            val[bb, i, :len(order)] = d2[bb, i, order]
    return idx, val


def room_cloud(rng, b, n, scale=1.0):
    return (rng.rand(b, n, 3) * scale).astype(np.float32) + ROOM


def ball_case(case):
    """(query, support, r2, k) of one case, numpy."""
    rng = np.random.RandomState(0)
    r2 = float(np.float32(0.15) * np.float32(0.15))
    if case == "random":
        s = room_cloud(rng, 2, 300)
        return np.concatenate([s[:, ::10], room_cloud(rng, 2, 7)], 1), s, r2, 16
    if case in ("on_the_radius", "one_ulp_inside"):
        s = room_cloud(rng, 2, 200)
        q = room_cloud(rng, 2, 33)
        planted = d2_np(q[:1, :1], s[:1, 7:8])[0, 0, 0]  # support 7 is exactly on query 0's radius
        r2 = planted if case == "on_the_radius" else np.nextafter(planted, np.float32(np.inf))
        return q, s, float(r2), 32
    if case == "short_and_empty":
        s = room_cloud(rng, 2, 150)
        q = np.concatenate([s[:, :20], s[:, :2] + 50.0], 1)  # two rows far from every support
        return q, s, float(np.float32(0.05) ** 2), 8
    if case == "several_tiles":  # hits on both sides of every tile and ballot boundary
        s = room_cloud(rng, 2, 2 * p2.MAX_TILE + 500, scale=0.6)
        return s[:, ::97].copy(), s, float(np.float32(0.1) ** 2), 32
    if case == "fewer_supports_than_k":
        s = room_cloud(rng, 2, 10, scale=0.1)
        return np.concatenate([s[:, :5], s[:, :1] + 9.0], 1), s, r2, 32
    raise ValueError(case)


BALL_CASES = ["random", "on_the_radius", "one_ulp_inside", "short_and_empty", "several_tiles",
              "fewer_supports_than_k"]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", BALL_CASES)
def test_ball_query_matches_its_contract(case, device):
    dev = device_of(device)
    q, s, r2, k = ball_case(case)
    want = ball_query_np(q, s, r2, k)
    tq, ts = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
    got = p2.ball_query(tq, ts, r2, k)
    assert got.dtype == torch.int32 and got.device.type == device
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if device == "cuda":
        torch.testing.assert_close(got, p2.ball_query_plain(tq, ts, r2, k), rtol=0, atol=0)
    ns = s.shape[1]
    if case == "on_the_radius":
        assert 7 not in want[0, 0] and (d2_np(q, s)[0, 0] < np.float32(r2)).any()
    if case == "one_ulp_inside":
        assert 7 in want[0, 0]
    if case == "short_and_empty":
        assert (want[:, -2:] == ns).all()
        short = (want[..., -1] == want[..., 0]) & (want[..., 0] < ns)
        assert short.any() and (want[..., 1] > want[..., 0]).any()
    if case == "several_tiles":
        full = want[..., -1] > want[..., 0]  # full rows and short ones, both across tiles
        assert full.any() and (~full).any() and (want[..., -1] >= p2.MAX_TILE).any() and (want[..., 0] < 32).any()
    if case == "fewer_supports_than_k":
        assert (want[:, :5, 10:] == want[:, :5, :1]).all() and (want[:, 5] == ns).all()


def nn_case(case):
    """(query, support) of one case, numpy."""
    rng = np.random.RandomState(1)
    if case == "random":
        s = room_cloud(rng, 2, 120)
        return np.concatenate([s[:, :40], room_cloud(rng, 2, 37)], 1), s
    if case == "ties":  # quarter-grid coordinates: every d² exact, many equal
        s = (rng.randint(0, 4, (2, 90, 3)) * 0.25).astype(np.float32)
        return (rng.randint(0, 4, (2, 45, 3)) * 0.25).astype(np.float32), s
    if case == "several_tiles":
        s = (rng.randint(0, 6, (2, 2 * p2.MAX_TILE + 300, 3)) * 0.25).astype(np.float32)
        return (rng.randint(0, 6, (2, 70, 3)) * 0.25).astype(np.float32), s
    if case in ("one_support", "two_supports"):
        return room_cloud(rng, 2, 9), room_cloud(rng, 2, 1 if case == "one_support" else 2)
    raise ValueError(case)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", ["random", "ties", "several_tiles", "one_support", "two_supports"])
def test_three_nn_matches_its_contract(case, device):
    dev = device_of(device)
    q, s = nn_case(case)
    want_i, want_d = three_nn_np(q, s)
    tq, ts = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
    got_i, got_d = neighbors.three_nn(tq, ts)
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_i.cpu().numpy(), want_i)
    np.testing.assert_array_equal(got_d.cpu().numpy().view(np.int32), want_d.view(np.int32))
    if device == "cuda":
        plain_i, plain_d = p2.three_nn_plain(tq, ts)
        torch.testing.assert_close(got_i, plain_i, rtol=0, atol=0)
        assert torch.equal(got_d.view(torch.int32), plain_d.view(torch.int32))
    if case in ("ties", "several_tiles"):  # ties broke between the chosen and the rest: the lower index won
        d2 = d2_np(q, s)
        third = np.take_along_axis(d2, want_i[..., 2:].astype(np.int64), -1)
        tied_later = (d2 == third) & (np.arange(s.shape[1]) > want_i[..., 2:])
        assert tied_later.any()
    if case == "one_support":
        assert (want_i == 0).all() and np.isinf(want_d[..., 1:]).all()
    if case == "two_supports":
        assert (want_i[..., 2] == 1).all() and np.isinf(want_d[..., 2]).all()


@pytest.mark.parametrize("radius", [0.1, 0.2, 0.4, 0.8, 0.15, 0.3333])
def test_ball_query_hands_over_the_float32_square_of_the_radius(radius, monkeypatch):
    seen = []
    monkeypatch.setattr(p2, "ball_query", lambda q, s, r2, k: seen.append(r2) or torch.zeros(1))
    neighbors.ball_query(torch.zeros(1, 1, 3), torch.zeros(1, 1, 3), radius, 4)
    want = (torch.tensor(radius, dtype=torch.float32) ** 2).item()
    assert type(seen[0]) is float and seen[0] == want
    assert np.float32(seen[0]) == np.float32(radius) * np.float32(radius)


@pytest.mark.parametrize("b,nq,ns", [(5, 2048, 8192), (5, 512, 2048), (5, 128, 512), (5, 32, 128),
                                     (5, 8192, 2048), (5, 2048, 512), (5, 512, 128), (5, 128, 32),
                                     (1, 1, 1), (3, 1000, 5000), (70000, 2, 2)])
def test_plans_come_from_the_shapes(b, nq, ns):
    """The cell's 8 searches (B = 5) and a few others: the most queries a
    CTA that keep two CTAs a streaming multiprocessor (else the fewest), a
    tile of 1 to ``MAX_TILE`` supports covering small clouds whole."""
    for plan, choices in ((p2.ball_query_plan(b, nq, ns), p2.BALL_WARPS),
                          (p2.three_nn_plan(b, nq, ns), p2.NN_THREADS)):
        assert plan.queries in choices and plan.tile == max(1, min(ns, p2.MAX_TILE))
        ctas = lambda q: b * -(-nq // q)  # noqa: E731
        want = p2.CTAS_PER_SM * p2.SMS
        if ctas(plan.queries) < want:
            assert plan.queries == choices[-1]
        else:
            assert all(ctas(c) < want for c in choices if c > plan.queries)


def test_fake_kernels_export_and_checks():
    g = torch.Generator().manual_seed(0)
    q, s = torch.rand(2, 40, 3, generator=g) + 3.0, torch.rand(2, 100, 3, generator=g) + 3.0
    real = (p2.ball_query_op(q, s, 0.04, 8), *p2.three_nn_op(q, s))
    with FakeTensorMode() as mode:
        fq, fs = mode.from_tensor(q), mode.from_tensor(s)
        fake = (p2.ball_query_op(fq, fs, 0.04, 8), *p2.three_nn_op(fq, fs))
    assert [(tuple(t.shape), t.dtype) for t in fake] == [(tuple(t.shape), t.dtype) for t in real] == [
        ((2, 40, 8), torch.int32), ((2, 40, 3), torch.int32), ((2, 40, 3), torch.float32)]

    class Searches(torch.nn.Module):
        def forward(self, query, support):
            return (neighbors.ball_query(query, support, 0.2, 8), *neighbors.three_nn(query, support))

    ep = torch.export.export(Searches(), (q, s))
    calls = [str(n.target) for n in ep.graph.nodes if n.op == "call_function" and "mvkpconv" in str(n.target)]
    assert calls == ["mvkpconv.ball_query.default", "mvkpconv.three_nn.default"]
    for got, want in zip(ep.module()(q, s), Searches()(q, s)):
        assert torch.equal(got, want)

    for bad, err in (((q.double(), s), TypeError), ((q[..., :2].contiguous(), s), ValueError),
                     ((q, s[:1].contiguous()), ValueError), ((q.transpose(0, 1), s), ValueError)):
        with pytest.raises(err):
            p2.check_args(*bad)
    with pytest.raises(ValueError, match="device"):
        p2.ball_query(q.to("meta"), s.to("meta"), 0.04, 8)
    with pytest.raises(ValueError, match="device"):
        p2.three_nn(q.to("meta"), s.to("meta"))


def test_both_searches_have_launch_counters():
    counts = tracing.launch_counts()
    assert {"ball_query", "three_nn"} <= set(counts)
    assert counts["ball_query"] == _build.LAUNCHES["ball_query"] and counts["three_nn"] == _build.LAUNCHES["three_nn"]
    assert (_build.SIGNATURES["mvkp_ball_query"][0], _build.SIGNATURES["mvkp_three_nn"][0]) == (
        {"ball_query": 1}, {"three_nn": 1})
