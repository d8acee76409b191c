"""PyTorch port: P1, the farthest-point-sampling operator
(``mvkpconv::farthest_point_sample``, ``ops/kernels/fps.py``), and the MVPNet
serving export (``eval/export.py``, ``kind='mvpnet'``).

  * The operator's CPU implementation, ``ops/sampling.farthest_point_sample``
    and the plain loop give the same indices as the JAX package's
    ``farthest_point_sample`` (a ``lax.fori_loop``): on random clouds, with a
    mask (padded tails at the shadow coordinate, everything masked but point
    0), with more samples than points (index 0 repeats), on exact ties
    (coordinates on a quarter grid: ties to the lowest index) and on copies
    of far corners placed on both sides of every CTA and warp boundary of
    the kernel's plan (equal d² across ranks and lanes: each corner is
    picked at its lowest copy).
  * ``fps.plan(N)`` for N from 1 to 100,000: 1, 2, 4 or 8 CTAs with
    contiguous index ranges in rank order that cover N, threads a multiple
    of 32 up to 1024, at most 8 points a thread in registers, and the
    scratch array exactly above 65,536 points; always an instance the
    kernel is built for (``fps.INSTANCES``).
  * The fake kernel gives the real one's shape and dtype; the wrapper's
    checks refuse what the CUDA kernel does not take, and ``fps.launch``
    a plan of no built instance or of another N.
  * ``export_inference(kind='mvpnet')``, saved and loaded by
    ``ServingModel``, at ``tests/test_export.py:119-145``'s configuration:
    the program calls FPS and the ball query (P1, P2) as operators once a
    set-abstraction level (4 each), the 3-NN (P2) once a propagation level
    (4) and K2 once, and its probabilities equal JAX's exported program's and
    JAX's ``make_apply_fn``'s on the same weights within that test's
    tolerance (rtol 1e-5, atol 1e-6), and the eager model's.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from mvkpconv_tpu.eval import export as jax_export  # noqa: E402
from mvkpconv_tpu.models import MVPNet3D as JaxMVPNet3D  # noqa: E402
from mvkpconv_tpu.ops import sampling as jax_sampling  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.steps import make_apply_fn  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.eval import export as E  # noqa: E402
from mvkpconv_tpu_torch.infer import infer  # noqa: E402
from mvkpconv_tpu_torch.models.mvpnet3d import MVPNet3D  # noqa: E402
from mvkpconv_tpu_torch.ops import sampling  # noqa: E402
from mvkpconv_tpu_torch.ops.common import SHADOW_COORD  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import fps  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

# tests/test_export.py:119-145: _cfg("none") with num_points (64, 16)
TINY = dict(
    architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary"),
    num_classes=5, in_features_dim=2, feature_2d_dim=0, first_features_dim=16, first_subsampling_dl=0.1,
    num_points=(64, 16), conv_neighbors=(12, 12), pool_neighbors=(12,), fusion="none", num_views=2,
    image_height=24, image_width=32, batch_num=1,
)
EXPORT_TOL = dict(rtol=1e-5, atol=1e-6)


def fps_case(case):
    """(points, num_samples, mask) of one input, numpy."""
    rng = np.random.RandomState(0)
    b, n = 2, 300
    pts = rng.rand(b, n, 3).astype(np.float32)
    if case == "plain":
        return pts, 96, None
    if case == "masked":
        mask = (rng.rand(b, n) > 0.4) | (np.arange(n) == 0)
        return pts, 80, mask
    if case == "padded_tail":
        mask = np.arange(n)[None].repeat(b, 0) < np.array([[n - 60], [n - 7]])
        return np.where(mask[..., None], pts, np.float32(SHADOW_COORD)), 120, mask
    if case == "only_point_0":
        return pts, 5, np.arange(n)[None].repeat(b, 0) == 0
    if case == "more_samples":
        return pts[:, :40], 70, None
    if case == "ties":  # quarter-grid coordinates: every d² exact, many equal
        return (rng.randint(0, 5, (b, n, 3)) * 0.25).astype(np.float32), 90, None
    if case == "ties_across_ranks":
        return boundary_duplicates(rng, b, 2049), 64, None
    raise ValueError(case)


def boundary_duplicates(rng, b, n):
    """Uniform points with copies of 4 far corners on both sides of every
    boundary of the kernel's plan for ``n`` (``fps.plan``: each rank's and
    each warp's first point and the point before it), a corner a boundary in
    turn, so equal d² meet across ranks and lanes."""
    pts = rng.rand(b, n, 3).astype(np.float32)
    corners = np.array([[4, 4, 4], [-4, -4, 4], [4, -4, -4], [-4, 4, -4]], np.float32)
    for j, i in enumerate(i for i in fps.plan(n).warp_starts() if i > 0):
        pts[:, i - 1:i + 1] = corners[j % len(corners)]
    return pts


@pytest.mark.parametrize("case", ["plain", "masked", "padded_tail", "only_point_0", "more_samples", "ties",
                                  "ties_across_ranks"])
def test_fps_operator_matches_plain_and_jax(case):
    pts, s, mask = fps_case(case)
    tm = None if mask is None else torch.from_numpy(mask)
    got = fps.fps_op(torch.from_numpy(pts), s, tm)
    assert got.dtype == torch.int32 and tuple(got.shape) == (pts.shape[0], s)
    torch.testing.assert_close(got, fps.farthest_point_sample_plain(torch.from_numpy(pts), s, tm), rtol=0, atol=0)
    torch.testing.assert_close(got, sampling.farthest_point_sample(torch.from_numpy(pts), s, tm), rtol=0, atol=0)
    fn = jax.jit(functools.partial(jax_sampling.farthest_point_sample, num_samples=s))
    want = np.asarray(fn(pts) if mask is None else fn(pts, mask=mask))
    np.testing.assert_array_equal(got.numpy(), want)
    got = got.numpy().astype(np.int64)
    assert (got[:, 0] == 0).all()
    if case in ("masked", "padded_tail"):
        assert np.take_along_axis(mask, got, 1).all()
    if case == "only_point_0":
        assert (got == 0).all()
    if case == "more_samples":
        n = pts.shape[1]
        assert all(sorted(set(g[:n])) == list(range(n)) for g in got) and (got[:, n:] == 0).all()
    if case == "ties":  # ties broke somewhere, else the case proves nothing
        d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
        assert (d2[0, 0] == d2[0, 0, got[0, 1]]).sum() > 1
    if case == "ties_across_ranks":  # each corner picked once, at its lowest copy, copies on several ranks
        plan = fps.plan(pts.shape[1])
        for g, p in zip(got, pts):
            far = np.abs(p).max(-1) == 4
            copies = {tuple(p[i]): np.flatnonzero((p == p[i]).all(-1)) for i in np.flatnonzero(far)}
            assert len(copies) == 4 and all(len({np.searchsorted([lo for lo, _ in plan.ranges()], c, "right")
                                                 for c in cs}) > 1 for cs in copies.values())
            picked = [i for i in g if far[i]]
            assert sorted(picked) == sorted(cs[0] for cs in copies.values()), (picked, copies)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 127, 128, 512, 2048, 8191, 8192, 8193, 20000, 65536, 65537, 100000])
def test_fps_plan_covers_every_n(n):
    """The kernel's plan for N points: 1, 2, 4 or 8 CTAs whose index ranges
    are contiguous, in rank order, and cover N (none empty); a CTA of a
    multiple of 32 threads up to 1024; at most 8 points a thread in
    registers covering the CTA's range, or (0) the scratch array above
    8 x 1024 x 8 points; warps' runs in index order from each range's start;
    a (CTAs, points a thread) pair the kernel is built for."""
    plan = fps.plan(n)
    assert plan.n == n and plan.clusters in (1, 2, 4, 8) and (plan.clusters, plan.points) in fps.INSTANCES
    fps.check_plan(plan, n)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    ranges = plan.ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == n and len(ranges) == plan.clusters
    assert all(lo < hi for lo, hi in ranges) and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert 0 <= plan.points <= 8 and (plan.points == 0) == (n > fps.REGISTER_POINTS)
    if plan.points:
        assert plan.threads * plan.points >= plan.span
    starts = plan.warp_starts()
    assert starts == sorted(set(starts)) and {lo for lo, _ in ranges} <= set(starts)
    assert len(starts) <= plan.clusters * plan.threads // 32
    assert fps.plan(n) == plan  # decided by N alone


def test_fps_fake_kernel_and_checks():
    g = torch.Generator().manual_seed(0)
    pts, mask = torch.rand(3, 50, 3, generator=g), torch.rand(3, 50, generator=g) > 0.5
    for m in (None, mask):
        real = fps.fps_op(pts, 37, m)
        with FakeTensorMode() as mode:
            fake = fps.fps_op(mode.from_tensor(pts), 37, None if m is None else mode.from_tensor(m))
        assert (tuple(fake.shape), fake.dtype) == (tuple(real.shape), real.dtype) == ((3, 37), torch.int32)
    fps.check_args(pts, 37, mask)
    for bad, err in (((pts.double(), 4, None), TypeError), ((pts[..., :2].contiguous(), 4, None), ValueError),
                     ((pts, 4, mask[:, :10].contiguous()), ValueError), ((pts, 4, mask.int()), TypeError),
                     ((pts.transpose(0, 1), 4, None), ValueError)):
        with pytest.raises(err):
            fps.check_args(*bad)
    with pytest.raises(ValueError, match="device"):
        fps.farthest_point_sample(pts.to("meta"), 4)
    for bad in (fps.Plan(50, 2, 32, 4), fps.Plan(50, 1, 32, 8)._replace(n=51), fps.Plan(50, 1, 32, 1)):
        with pytest.raises(ValueError, match="no plan of a built instance"):
            fps.launch(pts, 4, None, bad)


def mvpnet_batch(cfg):
    """tests/test_export.py:122-134's inputs (numpy): identity poses, a
    pinhole of focal 20 at the image centre, uniform points, images, depth."""
    rng = np.random.RandomState(0)
    batch = {}
    for k, s in E.batch_spec_for(cfg, "mvpnet").items():
        if k == "poses":
            batch[k] = np.tile(np.eye(4, dtype=np.float32), s.shape[:2] + (1, 1))
        elif k == "intrinsics":
            K = np.zeros(s.shape, np.float32)
            K[..., 0, 0] = K[..., 1, 1] = 20.0
            K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = cfg.image_width / 2, cfg.image_height / 2, 1.0
            batch[k] = K
        else:
            batch[k] = rng.rand(*s.shape).astype(np.float32)
    return batch


def test_mvpnet_export_round_trip_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # float32: the frozen UNet on K5
    cfg, jcfg = KPConfig(**TINY), JaxConfig(**TINY)
    batch = mvpnet_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxMVPNet3D(cfg.num_classes)
    variables = random_variables(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jb)))
    apply_fn = make_apply_fn(jmodel, jcfg, "mvpnet")
    want_apply = np.asarray(jax.nn.softmax(jax.jit(lambda v, b: apply_fn(v, b, False, False)[0])(variables, jb), -1))
    want_export = np.asarray(jax_export.ServingModel.from_bytes(
        jax_export.export_inference(jmodel, jcfg, "mvpnet", variables))(jb))

    model = load_jax_variables(MVPNet3D(cfg.num_classes), jax.tree.map(np.asarray, variables)).eval()
    path = E.save_exported(E.export_inference(model, cfg, "mvpnet"), tmp_path / "mvpnet.pt2")
    served = E.ServingModel.load(path)
    assert served.kind == "mvpnet" and sorted(served.input_spec) == sorted(batch)
    calls = [str(n.target) for n in served.program.graph.nodes
             if n.op == "call_function" and str(n.target).startswith("mvkpconv.")]
    assert sorted(calls) == ["mvkpconv.ball_query.default"] * 4 + ["mvkpconv.farthest_point_sample.default"] * 4 + [
        "mvkpconv.pixel_topk.default"] + ["mvkpconv.three_nn.default"] * 4 + [
        "mvkpconv.unet_conv.default"] * 45  # the frozen UNet, one K5 a convolution site; P2 a search
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = served(tb).numpy()
    assert got.shape == (1, cfg.num_points[0], cfg.num_classes)
    np.testing.assert_allclose(got, want_export, **EXPORT_TOL)
    np.testing.assert_allclose(got, want_apply, **EXPORT_TOL)
    np.testing.assert_allclose(got, torch.softmax(infer(model, tb), -1).numpy(), rtol=0, atol=1e-7)
