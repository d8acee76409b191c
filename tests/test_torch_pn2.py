"""PyTorch port: the MVPNet family's ops and models against the JAX package.

Ops (``mvkpconv_tpu_torch/ops/``), each contract stated where it is held:
``farthest_point_sample`` (indices equal, also with a mask and with more
samples than points), ``knn`` (indices equal or tied, d² within 1e-6
absolute), ``ball_query`` (indices equal except radius-boundary cases
within 1e-5·r²; the padding pinned), the 3-NN interpolation
(``three_nn`` then ``inverse_distance_interpolate``, as ``FeaturePropagation``
calls them, as close to a float64 truth as JAX's ``three_nn_interpolate``
is, a dense point on a key included), the brute-force
pixel k-NN (equal or tied with JAX's ``method='exact'``). Models: the
PN2SSG and MVPNet3D forwards in eval mode, JAX variables bridged by
``convert.py``, logits within 1e-4·max|logit| (MVPNet3D with poses, the
port's K2 plain version against JAX's ``minext`` selection, and without
poses, the brute-force association); the dropout's rate and scale. JAX
runs jitted on the CPU, as its model applies run.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.models.feature_aggregation import FeatureAggregation as JaxFA  # noqa: E402
from mvkpconv_tpu.models.mvpnet3d import MVPNet3D as JaxMVPNet3D  # noqa: E402
from mvkpconv_tpu.models.pn2 import PN2SSG as JaxPN2SSG  # noqa: E402
from mvkpconv_tpu.models.unet2d import UNetResNet34 as JaxUNet  # noqa: E402
from mvkpconv_tpu.ops import interpolate as jax_interp  # noqa: E402
from mvkpconv_tpu.ops import neighbors as jax_nb  # noqa: E402
from mvkpconv_tpu.ops import sampling as jax_sampling  # noqa: E402
from mvkpconv_tpu.ops import unproject as jax_unproject  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.data.synthetic_batch import make_batch  # noqa: E402
from mvkpconv_tpu_torch.models.mvpnet3d import MVPNet3D  # noqa: E402
from mvkpconv_tpu_torch.models.pn2 import PN2SSG  # noqa: E402
from mvkpconv_tpu_torch.ops.interpolate import inverse_distance_interpolate  # noqa: E402
from mvkpconv_tpu_torch.ops.neighbors import ball_query, knn, three_nn  # noqa: E402
from mvkpconv_tpu_torch.ops.sampling import farthest_point_sample  # noqa: E402
from mvkpconv_tpu_torch.ops.unproject import points_to_pixel_knn  # noqa: E402
from mvkpconv_tpu_torch.training.init import init_parameters  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

# PN2SSG cut to test size (tests/test_models.py's centroids)
SMALL_PN2 = dict(num_centroids=(64, 16, 8, 4))
LOGIT_REL = 1e-4
T = torch.from_numpy


def cloud(rng, b, n, scale=1.0):
    return (rng.rand(b, n, 3) * scale).astype(np.float32)


def d2_of(q, s, idx):
    """(B, Nq, K) squared distances of the selected supports, float64."""
    sel = np.take_along_axis(s.astype(np.float64)[:, None], idx.astype(np.int64)[..., None], 2)
    return ((sel - q.astype(np.float64)[:, :, None]) ** 2).sum(-1)


# ---- ops --------------------------------------------------------------------

@pytest.mark.parametrize("num_samples,masked", [(128, False), (100, True), (600, False)])
def test_fps_matches_jax(num_samples, masked, rng):
    """Indices equal: first centroid 0, ties to the lowest index, masked
    points never picked; with more samples than the 512 points index 0
    repeats once all are taken (the JAX CLI tests run 2048 on 512)."""
    pts = cloud(rng, 2, 512)
    mask = rng.rand(2, 512) > 0.3 if masked else None
    mask = None if mask is None else mask | (np.arange(512) == 0)
    fn = jax.jit(functools.partial(jax_sampling.farthest_point_sample, num_samples=num_samples))
    want = np.asarray(fn(pts) if mask is None else fn(pts, mask=mask))
    got = farthest_point_sample(T(pts), num_samples, None if mask is None else T(mask)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if mask is not None:
        assert np.take_along_axis(mask, got.astype(np.int64), 1).all()
    if num_samples > 512:
        assert sorted(set(got[0, :512])) == list(range(512)) and (got[:, 512:] == 0).all()


@pytest.mark.parametrize("k", [3, 16, 250])
def test_knn_matches_jax(k, rng):
    """Indices equal or tied (the d² of a differing entry within 1e-6 of
    JAX's at that slot); d² within 1e-6 absolute; k beyond the 200
    supports pads with index Ns − 1 at d² = inf, as JAX does."""
    q, s = cloud(rng, 2, 300), cloud(rng, 2, 200)
    q[:, :40] = s[:, :40]  # queries on a support: d² exactly 0 in both
    want_i, want_d = map(np.asarray, jax.jit(functools.partial(jax_nb.knn, k=k))(q, s))
    got_i, got_d = knn(T(q), T(s), k)
    got_i, got_d = got_i.numpy(), got_d.numpy()
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(got_d), fin)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=0, atol=1e-6)
    differ = (got_i != want_i) & fin
    assert differ.mean() < 0.01, differ.mean()
    np.testing.assert_allclose(got_d[differ], want_d[differ], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_i[~fin], want_i[~fin])
    assert (got_d[:, :40, 0] == 0).all() and (got_i[:, :40, 0] == np.arange(40)).all()


def test_ball_query_matches_jax(rng):
    """Indices equal, except where a support lies on the radius: every
    differing row's symmetric difference has d² within 1e-5·r² of r²."""
    s = cloud(rng, 2, 1024)
    q = s[:, ::8].copy()
    r, k = 0.15, 16
    want_i = np.asarray(jax.jit(functools.partial(jax_nb.ball_query, radius=r, k=k))(q, s))
    got_i = ball_query(T(q), T(s), r, k).numpy()
    assert got_i.dtype == np.int32
    rows = np.argwhere((got_i != want_i).any(-1))
    assert len(rows) <= 2, len(rows)
    for bb, qq in rows:
        odd = set(got_i[bb, qq]) ^ set(want_i[bb, qq])
        gaps = np.abs(d2_of(q[bb:bb + 1, qq:qq + 1], s[bb:bb + 1], np.array(sorted(odd))[None, None]) - r * r)
        assert (gaps <= 1e-5 * r * r).all(), gaps


def test_ball_query_padding_is_pinned():
    """The first k hits in index order (not by distance); a short row
    repeats its first hit; a row with no hit holds Ns throughout — the
    JAX package's (and the reference's) semantics."""
    s = np.array([[[0.5, 0, 0], [0.05, 0, 0], [9, 9, 9], [0.01, 0, 0], [0, 0.02, 0], [0, 0, 0.03]]],
                 np.float32)
    q = np.array([[[0, 0, 0], [9, 9, 9.05], [5, 5, 5]]], np.float32)
    got = ball_query(T(q), T(s), 0.1, 3).numpy()
    want = np.asarray(jax_nb.ball_query(q, s, 0.1, 3))
    np.testing.assert_array_equal(got, [[[1, 3, 4], [2, 2, 2], [6, 6, 6]]])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ball_query(T(q), T(s), 0.1, 8).numpy(),
                                  np.asarray(jax_nb.ball_query(q, s, 0.1, 8)))


def interpolate_f64(dense, sparse, feat, idx):
    """3-NN interpolation in float64 on the given neighbors: the truth
    both packages' f32 expansion d² rounds away from."""
    inv = 1.0 / np.maximum(d2_of(dense, sparse, idx), 1e-10)
    sel = np.take_along_axis(feat.astype(np.float64)[:, None], idx.astype(np.int64)[..., None], 2)
    return (sel * (inv / inv.sum(-1, keepdims=True))[..., None]).sum(-2)


def test_three_nn_interpolate_matches_jax(rng):
    """The port's 3-NN interpolation, as ``FeaturePropagation`` makes it
    (``three_nn``, then ``inverse_distance_interpolate``), and JAX's
    ``three_nn_interpolate``, each package against a float64 truth on its
    own neighbors (equal here), with a quarter of the dense points on a key
    as at FP3, where every centroid is a dense point (d² exactly 0 there in
    both packages: the weight is 1/1e-10). Elsewhere JAX's expansion form rounds with
    ‖q‖², not d², so the weights 1/d² of close neighbors follow it; the
    port takes the difference form of the published CUDA op
    (``common.difference_sq_dists``), whose rounding scales with d². The
    witness is JAX's own error: the port's RMS error within 2x JAX's, its
    largest within 4x (with the port on the expansion form too, over seeds
    0-29 the ratios read 0.71-1.63 and 0.43-2.30; JAX's largest error
    2.1e-5-4.9e-5 of max|output| over seeds 0-5)."""
    dense = cloud(rng, 2, 512)
    sparse = dense[:, ::4].copy()
    feat = rng.randn(2, 128, 16).astype(np.float32)
    want = np.asarray(jax.jit(jax_interp.three_nn_interpolate)(dense, sparse, feat))
    index, sqdist = three_nn(T(dense), T(sparse))  # FeaturePropagation.forward's two calls
    got = inverse_distance_interpolate(T(feat), index, sqdist).numpy()
    want_idx = np.asarray(jax.jit(functools.partial(jax_nb.knn, k=3))(dense, sparse)[0])
    got_idx = index.numpy()
    np.testing.assert_array_equal(got_idx, want_idx)
    jax_err = want - interpolate_f64(dense, sparse, feat, want_idx)
    port_err = got - interpolate_f64(dense, sparse, feat, got_idx)
    rms = float(np.sqrt((port_err**2).mean() / (jax_err**2).mean()))
    worst = float(np.abs(port_err).max() / np.abs(jax_err).max())
    assert np.abs(jax_err).max() < 1e-4 * np.abs(want).max()  # the witness is itself small
    assert rms <= 2.0 and worst <= 4.0, (rms, worst)
    # a dense point on a key takes (nearly) that key's feature: weight 1e10
    np.testing.assert_allclose(got[:, ::4], feat, rtol=0, atol=1e-3)


def test_brute_force_pixel_knn_matches_jax(rng):
    """Equal or tied with JAX ``points_to_pixel_knn(method='exact')``;
    invalid pixels (at SHADOW_COORD) are never selected."""
    img = cloud(rng, 2, 2 * 12 * 16).reshape(2, 2, 12, 16, 3)
    img[:, :, :2] = 1e6
    pts = cloud(rng, 2, 256)
    want = np.asarray(jax.jit(functools.partial(jax_unproject.points_to_pixel_knn, k=3,
                                                method="exact"))(pts, img))
    got = points_to_pixel_knn(T(pts), T(img), 3).numpy()
    flat = img.reshape(2, -1, 3)
    differ = got != want
    np.testing.assert_allclose(d2_of(pts, flat, got)[differ], d2_of(pts, flat, want)[differ], atol=1e-6)
    assert (np.take_along_axis(flat[..., 0], got.reshape(2, -1).astype(np.int64), 1) < 1e5).all()


# ---- models -----------------------------------------------------------------

class SmallJaxMVPNet3D(JaxMVPNet3D):
    """The JAX MVPNet3D with its PN2SSG cut to test size."""

    dropout: float = 0.5

    def setup(self):
        self.net_2d = JaxUNet(self.num_classes, dtype=self.dtype)
        self.feat_aggreg = JaxFA(self.feat_channels, dtype=self.dtype)
        self.net_3d = JaxPN2SSG(self.num_classes, dtype=self.dtype, dropout=self.dropout, **SMALL_PN2)


def mvpnet_config(n=512):
    return JaxConfig(fusion="early", in_features_dim=66, num_points=(n, n // 4),
                     architecture=("simple", "resnetb_strided", "nearest_upsample", "unary"),
                     conv_neighbors=(8, 8), pool_neighbors=(8,), num_views=2,
                     image_height=24, image_width=32, num_classes=6)


@functools.lru_cache(maxsize=None)
def mvpnet_setup(n=512):
    """(numpy batch with depth and poses, JAX variables) of the test-size
    MVPNet3D; the batch's points are the unpadded sphere of ``make_batch``."""
    cfg = mvpnet_config(n)
    batch = make_batch(cfg, 2, np.random.RandomState(0))
    batch = {k: batch[k] for k in ("points", "images", "depth", "intrinsics", "poses")}
    batch["labels"] = np.random.RandomState(1).randint(0, 6, (2, n)).astype(np.int32)
    model = SmallJaxMVPNet3D(6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jb))
    return batch, random_variables(shapes, seed=2)


def port_mvpnet(variables, freeze_2d=True, dropout=0.0):
    model = MVPNet3D(6, freeze_2d=freeze_2d, dropout=dropout, **SMALL_PN2)
    return load_jax_variables(model, jax.tree.map(np.asarray, variables)).eval()


def assert_logits_close(got, want):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_REL * scale, (err, scale)


def test_pn2ssg_forward_matches_jax(rng):
    pts = cloud(rng, 2, 256)
    feats = rng.randn(2, 256, 8).astype(np.float32)
    model = JaxPN2SSG(6, **SMALL_PN2)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), pts, feats))
    variables = random_variables(shapes, seed=1)
    want = np.asarray(jax.jit(lambda v, p, f: model.apply(v, p, f))(variables, pts, feats))
    port = load_jax_variables(PN2SSG(6, in_channels=8, **SMALL_PN2), jax.tree.map(np.asarray, variables))
    with torch.no_grad():
        got = port.eval()(T(pts), T(feats)).numpy()
    assert_logits_close(got, want)
    # the widths SharedMLP is given: SA i feature + 3, FP i sparse + skip, FP3 no skip
    assert [getattr(port, f"sa{i}").mlp.dense0.in_features for i in range(4)] == [11, 67, 131, 259]
    assert [getattr(port, f"fp{i}").mlp.dense0.in_features for i in range(4)] == [768, 384, 320, 128]


@pytest.mark.parametrize("poses", [True, pytest.param(False, marks=pytest.mark.slow)])  # JAX compiles: 3-6 s each
def test_mvpnet3d_forward_matches_jax(poses):
    """With poses the port selects pixels by K2's plain version, held
    against JAX's ``minext`` selection (its indices handed to the JAX model
    as ``knn_indices``); without poses both take the brute-force k-NN."""
    batch, variables = mvpnet_setup()
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    image_xyz, _ = jax.jit(jax_unproject.unproject_depth)(jb["depth"], jb["intrinsics"], jb["poses"])
    jb["image_xyz"] = image_xyz
    if poses:
        jb["knn_indices"] = jax.jit(functools.partial(
            jax_unproject.points_to_pixel_knn_projective, k=3, window=9, method="minext"))(
            jb["points"], image_xyz, jb["intrinsics"], jb["poses"])
        tb = {k: T(v) for k, v in batch.items() if k != "labels"}
    else:
        for key in ("depth", "intrinsics", "poses"):
            jb.pop(key)
        tb = {"points": T(batch["points"]), "images": T(batch["images"]),
              "image_xyz": torch.tensor(np.asarray(image_xyz))}
    model = SmallJaxMVPNet3D(6)
    want = np.asarray(jax.jit(lambda v, b: model.apply(v, b))(variables, jb))
    with torch.no_grad():
        got = port_mvpnet(variables)(tb).numpy()
    assert_logits_close(got, want)


def test_pn2_dropout_rate_and_scale_from_its_generator():
    """Dropout before ``seg_logit``: a share p of the entries zeroed, the
    rest scaled by 1/(1 − p) (flax's), the masks drawn from the model's own
    generator: the same seed gives the same masks, another seed others, and
    eval mode none."""
    torch.manual_seed(0)
    x = torch.rand(2, 256, 3)

    def logits_and_hidden(seed, train=True):
        model = init_parameters(PN2SSG(6, **SMALL_PN2, seed=seed), 0).train(train)
        hidden = []
        model.seg_logit.register_forward_hook(lambda m, inp, out: hidden.append(inp[0]))
        model.mlp_seg.register_forward_hook(lambda m, inp, out: hidden.append(out))
        with torch.no_grad():
            out = model(x)
        return out, hidden

    _, (before, after) = logits_and_hidden(7)
    dropped = after == 0
    kept = ~dropped & (before != 0)
    rate = float(dropped[before != 0].float().mean())
    assert abs(rate - 0.5) < 0.01, rate
    torch.testing.assert_close(after[kept], before[kept] / 0.5)
    _, (_, again) = logits_and_hidden(7)
    assert torch.equal(again, after)
    _, (_, other) = logits_and_hidden(8)
    assert not torch.equal(other == 0, dropped)
    _, (b_eval, a_eval) = logits_and_hidden(7, train=False)
    assert torch.equal(a_eval, b_eval)
