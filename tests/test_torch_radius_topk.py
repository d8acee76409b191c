"""PyTorch port, kernel K1: the arithmetic of the box skip test, on the CPU.

The CUDA kernel skips a group of 32 consecutive supports (and a super-group
of 32 groups) when ``box_lower_bound`` of the query and the group's box is
≥ r². ``ops/kernels/radius_topk.py`` mirrors that arithmetic operation by
operation (``group_boxes``, ``box_lower_bound``); these tests hold that

  * the bound never exceeds the rounded d² of any pair it covers, so a group
    that holds a support with rounded d² < r² is never rejected: sorted,
    shuffled and padded inputs, coordinates at 1e6, supports placed at and
    just under r², and hypothesis-made clouds;
  * a search that applies the skip and then the plain selection returns
    exactly the plain version's indices (the plain version stays the
    reference of the function);
  * the boxes are taken from the data: every point lies in its group's box
    and every group's box in its super-group's, whatever the order, also
    when N is no multiple of the group size;
  * the plain versions of K1 and K4 give what they gave before the kernels
    were redesigned (pinned digests and sums at small bench-shaped
    configurations).
"""

import hashlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
from mvkpconv_tpu_torch.models.kernel_points import kernel_point_positions
from mvkpconv_tpu_torch.ops.gather import group_points, pad_shadow_row
from mvkpconv_tpu_torch.ops.kernels import kpconv as k4
from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid
from mvkpconv_tpu_torch.training.config import KPConfig
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

SMALL = dict(
    fusion="early", in_features_dim=66, num_points=(1024, 256, 64, 32, 16),
    conv_neighbors=(16,) * 5, pool_neighbors=(16,) * 4,
    first_features_dim=32, num_views=3, image_height=24, image_width=32,
)


def _cloud(kind, n=1024, b=2, seed=0):
    """(B, N, 3) float32 points of the synthetic batch: voxel-sorted as the
    data pipeline emits them, shuffled, with a padded tail at 1e6, or the
    whole cloud moved out to 1e6."""
    cfg = KPConfig(**{**SMALL, "num_points": (n,) + SMALL["num_points"][1:]})
    pts = make_batch(cfg, b, np.random.RandomState(seed))["points"].copy()
    rng = np.random.RandomState(seed + 1)
    if kind == "shuffled":
        for i in range(b):
            pts[i] = pts[i][rng.permutation(n)]
    elif kind == "padded":
        pts[:, -(n // 5):] = np.float32(1e6)
    elif kind == "far":
        pts += np.float32(1e6)
    return torch.from_numpy(pts)


def _d2(query, support):
    """(B, Nq, Ns) rounded d², the difference form of the kernel and its plain version."""
    diff = query[:, :, None, :] - support[:, None, :, :]
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]


def _bounds(query, support, group):
    """(B, Nq, G) ``box_lower_bound`` of every query against every group box,
    and the (B, Nq, G) least rounded d² of the query to the group's points."""
    lo, hi = k1.group_boxes(support, group)
    q = query[:, :, None, :]
    bound = k1.box_lower_bound(q, q, lo[:, None], hi[:, None])
    d2 = _d2(query, support)
    b, nq, ns = d2.shape
    pad = -ns % group
    d2 = torch.cat([d2, d2.new_full((b, nq, pad), float("inf"))], dim=-1)
    return bound, d2.reshape(b, nq, -1, group).amin(dim=-1)


def _boxed_search(query, support, radius, k):
    """The kernel's search in PyTorch: supports of a group or super-group
    whose box bound is ≥ r² are never looked at; the rest go through the plain
    selection."""
    r2 = torch.tensor(k1.squared_radius(radius), dtype=torch.float32)
    ns = support.shape[1]
    lo, hi = k1.group_boxes(support, k1.GROUP)
    s_lo, _ = k1.group_boxes(lo, k1.SUPER)
    _, s_hi = k1.group_boxes(hi, k1.SUPER)
    q = query[:, :, None, :]
    keep_group = k1.box_lower_bound(q, q, lo[:, None], hi[:, None]) < r2
    keep_super = k1.box_lower_bound(q, q, s_lo[:, None], s_hi[:, None]) < r2
    keep_group &= keep_super.repeat_interleave(k1.SUPER, dim=-1)[..., : keep_group.shape[-1]]
    seen = keep_group.repeat_interleave(k1.GROUP, dim=-1)[..., :ns]  # (B, Nq, Ns)
    out = []
    for b in range(query.shape[0]):
        rows = []
        for i in range(query.shape[1]):
            idx = torch.nonzero(seen[b, i]).flatten()
            if idx.numel() == 0:
                rows.append(torch.full((k,), ns, dtype=torch.int32))
                continue
            got = k1.radius_topk_plain(query[b:b + 1, i:i + 1], support[b:b + 1, idx], radius, k)[0, 0]
            rows.append(torch.where(got < idx.numel(), idx[got.clamp(max=idx.numel() - 1).long()].int(),
                                    torch.full_like(got, ns)))
        out.append(torch.stack(rows))
    return torch.stack(out), float(seen.float().mean())


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("kind", ["sorted", "shuffled", "padded", "far"])
def test_bound_never_exceeds_the_rounded_d2_of_a_covered_pair(kind, group):
    pts = _cloud(kind)
    bound, least = _bounds(pts, pts, group)
    assert bool(torch.isfinite(bound).all())
    assert bool((bound <= least).all()), float((bound - least).max())
    # and so no group that holds a support within the radius is rejected
    r2 = k1.squared_radius(0.1)
    assert not bool(((bound >= r2) & (least < r2)).any())


@pytest.mark.parametrize("kind", ["sorted", "shuffled", "padded"])
def test_super_group_bound_never_exceeds_its_groups_bounds(kind):
    pts = _cloud(kind, n=2048 + 40)  # three super-groups, the last ragged
    lo, hi = k1.group_boxes(pts, k1.GROUP)
    s_lo, _ = k1.group_boxes(lo, k1.SUPER)
    _, s_hi = k1.group_boxes(hi, k1.SUPER)
    q = pts[:, :, None, :]
    group_bound = k1.box_lower_bound(q, q, lo[:, None], hi[:, None])
    super_bound = k1.box_lower_bound(q, q, s_lo[:, None], s_hi[:, None])
    spread = super_bound.repeat_interleave(k1.SUPER, dim=-1)[..., : group_bound.shape[-1]]
    assert bool((spread <= group_bound).all())


@pytest.mark.parametrize("n", [1024, 1000, 33, 31, 1])
def test_boxes_come_from_the_data_and_hold_every_point(n):
    pts = _cloud("shuffled", n=1024)[:, :n]
    lo, hi = k1.group_boxes(pts, k1.GROUP)
    groups = -(-n // k1.GROUP)
    assert lo.shape == hi.shape == (pts.shape[0], groups, 3)
    of_point = torch.arange(n) // k1.GROUP
    assert bool((lo[:, of_point] <= pts).all()) and bool((pts <= hi[:, of_point]).all())
    # tight: each face of a box touches a point of the group, also in the ragged last one
    for g in (0, groups - 1):
        mine = pts[:, g * k1.GROUP:(g + 1) * k1.GROUP]
        assert torch.equal(lo[:, g], mine.amin(dim=1)) and torch.equal(hi[:, g], mine.amax(dim=1))


def test_supports_at_and_just_under_the_radius_in_another_group():
    """Supports at rounded d² exactly r² (out) and one float below (in), in a
    group of their own: the group is kept exactly when it holds a support
    within the radius."""
    radius = 0.1
    r = np.float32(radius)
    r2 = np.float32(k1.squared_radius(radius))
    under = np.nextafter(r, np.float32(0))
    assert np.float32(under * under) < r2 == np.float32(r * r)
    query = torch.zeros(1, 1, 3)
    far = np.tile(np.array([[5.0, 5.0, 5.0]], np.float32), (32, 1))
    for off, inside in ((r, False), (under, True), (np.nextafter(r, np.float32(1)), False)):
        for axis in range(3):
            for sign in (1.0, -1.0):
                probe = np.zeros((1, 3), np.float32)
                probe[0, axis] = sign * off
                # group 0 far away; group 1 holds the probe alone (32 copies: its box is the point)
                support = torch.from_numpy(np.concatenate([far, np.tile(probe, (32, 1))])[None])
                bound, least = _bounds(query, support, k1.GROUP)
                assert bool((bound <= least).all())
                assert bool(bound[0, 0, 1] < r2) == inside == bool(least[0, 0, 1] < r2)
                got = k1.radius_topk_plain(query, support, radius, 4)
                assert got[0, 0, 0].item() == (32 if inside else support.shape[1])


@pytest.mark.parametrize("kind,radius,k", [
    ("sorted", 0.1, 16), ("shuffled", 0.1, 16), ("padded", 0.1, 30), ("sorted", 0.3, 1), ("far", 0.1, 8),
])
def test_search_with_the_skip_equals_the_plain_version(kind, radius, k):
    pts = _cloud(kind, n=512, b=1)
    query = pts[:, ::4].contiguous()
    got, seen = _boxed_search(query, pts, radius, k)
    want = k1.radius_topk_plain(query, pts, radius, k)
    assert torch.equal(got, want)
    if kind == "sorted" and radius == 0.1:
        assert seen < 0.5  # the skip does skip on voxel-sorted input


def test_padded_queries_select_the_first_padded_supports_through_the_skip():
    pts = _cloud("padded", n=512, b=1)
    got, _ = _boxed_search(pts[:, -8:].contiguous(), pts, 0.1, 10)
    first_pad = 512 - 512 // 5
    assert bool((got == torch.arange(first_pad, first_pad + 10, dtype=torch.int32)).all())


coords = st.floats(min_value=-2.0, max_value=2.0, allow_nan=False, width=32)


@settings(max_examples=60, deadline=None)
@given(
    st.lists(st.tuples(coords, coords, coords), min_size=1, max_size=70),
    st.lists(st.tuples(coords, coords, coords), min_size=1, max_size=12),
    st.sampled_from([1, 3, 8, 32]),
    st.sampled_from([0.0, 1.0, 1e3, 1e6]),
    st.sampled_from([1.0, 1e-3, 37.5]),
)
def test_bound_is_conservative_for_any_cloud(support, query, group, offset, scale):
    s = (torch.tensor(support, dtype=torch.float32) * scale + offset)[None]
    q = (torch.tensor(query, dtype=torch.float32) * scale + offset)[None]
    bound, least = _bounds(q, s, group)
    assert bool(torch.isfinite(bound).all())
    assert bool((bound <= least).all())
    # box against box: the bound of two groups' boxes covers every pair of their points
    q_lo, q_hi = k1.group_boxes(q, group)
    s_lo, s_hi = k1.group_boxes(s, group)
    pair = k1.box_lower_bound(q_lo[:, :, None], q_hi[:, :, None], s_lo[:, None], s_hi[:, None])
    nq = q.shape[1]
    pad = -nq % group
    least_q = torch.cat([least, least.new_full((1, pad, least.shape[2]), float("inf"))], dim=1)
    least_qg = least_q.reshape(1, -1, group, least.shape[2]).amin(dim=2)
    assert bool((pair <= least_qg).all())


def _digest(t):
    return hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()[:16]


# sha256 prefixes of the index tensors that ``build_pyramid`` (13 calls of K1's
# plain version) gave at this configuration before the kernel was redesigned
PYRAMID_DIGESTS = {
    "neighbors": [
        "c29224b268c53d1d",
        "f9b26807a55cc336",
        "544e71c2b6c3d1e4",
        "6eb66b25920bab1b",
        "760b648938240bf2",
    ],
    "pools": [
        "3a33e96f52454c2a",
        "cc44020b4140b7a5",
        "5e159e18687bd6d0",
        "b5e58af594a30137",
    ],
    "upsamples": [
        "5f8166e5b1060108",
        "b6a21f290e73c481",
        "f0e7e28660028732",
        "2659cde4e210845d",
    ],
}


def test_k1_plain_version_is_unchanged_on_the_small_bench_shaped_pyramid():
    cfg = KPConfig(**SMALL)
    raw = make_batch(cfg, 2, np.random.RandomState(0))
    raw["mask"][-1, -40:] = False
    pts = np.where(raw["mask"][..., None], raw["points"], np.float32(1e6)).astype(np.float32)
    pyr = build_pyramid(torch.from_numpy(pts), torch.from_numpy(raw["mask"]), cfg.pyramid_spec())
    for name, want in PYRAMID_DIGESTS.items():
        assert [_digest(t) for t in getattr(pyr, name)] == want, name


# (sum, sum of |·|, [0, 5, 3]) of the K4 plain versions' results on the inputs
# below, before the forward kernel was redesigned
K4_PLAIN_SUMS = {
    "fwd": [-12.282978841605654, 4663.433973153449, 0.7257738709449768],
    "bwd_x": [37.28131769363972, 4268.479252760189, -0.08381712436676025],
    "wf": [-604.6474916319191, 35751.843151710505, -0.4230591058731079],
}


def test_k4_plain_versions_are_unchanged_at_a_small_conv_site():
    cfg = KPConfig(**SMALL)
    raw = make_batch(cfg, 2, np.random.RandomState(0))
    pts, mask = torch.from_numpy(raw["points"]), torch.from_numpy(raw["mask"])
    pyr = build_pyramid(pts, mask, cfg.pyramid_spec())
    spec = cfg.pyramid_spec()
    radius, cin, cout, m = spec.radius(0), 12, 10, cfg.num_kernel_points
    extent = radius * cfg.kp_extent / cfg.conv_radius
    kp = torch.from_numpy(kernel_point_positions(radius, m))
    gen = torch.Generator().manual_seed(0)
    s_pad = torch.cat([pts, torch.full_like(pts[:, :1], 1e6)], dim=1)
    rel = group_points(s_pad, pyr.neighbors[0]) - pts[:, :, None, :]
    nx = group_points(pad_shadow_row(torch.randn(2, pts.shape[1], cin, generator=gen)), pyr.neighbors[0])
    w2d = torch.randn(m * cin, cout, generator=gen) / (m * cin) ** 0.5
    g = torch.randn(2, pts.shape[1], cout, generator=gen)
    got = {
        "fwd": k4.kpconv_fused_plain(rel, nx, kp, w2d, extent),
        "bwd_x": k4.kpconv_fused_bwd_x_plain(rel, g, kp, w2d, extent)[:, :, 0],
        "wf": k4.kpconv_wf_plain(rel, nx, kp, extent),
    }
    for name, t in got.items():
        have = np.array([float(t.double().sum()), float(t.double().abs().sum()), float(t[0, 5, 3])])
        np.testing.assert_allclose(have, np.array(K4_PLAIN_SUMS[name]), rtol=2e-5, atol=1e-6, err_msg=name)
