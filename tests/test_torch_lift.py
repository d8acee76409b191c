"""PyTorch port: the 2D→3D lift — unprojection, projection, kernel K2's plain
version, UNet-ResNet34 and FeatureAggregation — held against the JAX
package on the same numpy inputs and the same (converted) weights.

Tolerances:
  * geometry: unprojected pixels within 1e-5 absolute, projected pixel
    coordinates within 2e-5 relative (f32 sums of products in another
    order; the division by depth amplifies them far off-image);
  * pixel indices with f32 candidates: equal to JAX ``minext`` (or a tie of
    the selected d² within 1e-6 relative); with bf16 candidates, the
    selected d² agree with the TPU kernel's (interpret mode) within 2⁻¹⁴
    relative — JAX's CPU ``minext`` rounds the points to bf16 as well, so
    it is not the reference there;
  * network outputs in f32: max |Δ| ≤ 1e-4 · max |out|; in bf16:
    max |Δ| ≤ 2e-2 · max |out|.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import linen as fnn  # noqa: E402

from mvkpconv_tpu.data import synthetic  # noqa: E402
from mvkpconv_tpu.models.feature_aggregation import (  # noqa: E402
    FeatureAggregation as JaxFeatureAggregation,
)
from mvkpconv_tpu.models.unet2d import UNetResNet34 as JaxUNet  # noqa: E402
from mvkpconv_tpu.ops.pallas.pixel_select import pixel_topk_indices  # noqa: E402
from mvkpconv_tpu.ops.unproject import (  # noqa: E402
    points_to_pixel_knn_projective as jax_pixel_knn,
    project_to_views as jax_project,
    unproject_depth as jax_unproject,
)
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.models.feature_aggregation import FeatureAggregation  # noqa: E402
from mvkpconv_tpu_torch.models.unet2d import ConvTranspose2d, UNetResNet34  # noqa: E402
from mvkpconv_tpu_torch.ops.kernels import pixel_select as k2  # noqa: E402
from mvkpconv_tpu_torch.ops.unproject import (  # noqa: E402
    points_to_pixel_knn_projective,
    project_to_views,
    unproject_depth,
    window_anchors,
)
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

GEOM_ATOL = 1e-5
PROJ_REL = 2e-5
TIE_REL_F32 = 1e-6
BF16_SEL_REL = 2.0**-14
F32_REL = 1e-4
BF16_REL = 2e-2


def perturb(variables, seed=0):
    """Random BN statistics / scales / biases, so every leaf's layout counts."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, variables))


def assert_close_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale, rel)


def _scene(seed=11, h=48, w=64, v=3, n=300):
    scene = synthetic.make_scene(seed=seed, num_points=30000)
    views = synthetic.render_views(scene, v, h, w, seed=seed)
    rng = np.random.RandomState(seed)
    pts = scene["points"][rng.choice(len(scene["points"]), n, replace=False)]
    return (
        pts[None].astype(np.float32),
        views["depth"][None].astype(np.float32),
        views["intrinsics"][None].astype(np.float32),
        views["poses"][None].astype(np.float32),
    )


def test_unproject_and_project_match_jax():
    pts, depth, intr, poses = _scene()
    want_xyz, want_valid = jax_unproject(*map(jnp.asarray, (depth, intr, poses)))
    got_xyz, got_valid = unproject_depth(*map(torch.from_numpy, (depth, intr, poses)))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got_xyz.numpy(), np.asarray(want_xyz), rtol=0, atol=GEOM_ATOL)
    wu, wv = jax_project(*map(jnp.asarray, (pts, intr, poses)))
    gu, gv = project_to_views(*map(torch.from_numpy, (pts, intr, poses)))
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu), rtol=PROJ_REL, atol=GEOM_ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=PROJ_REL, atol=GEOM_ATOL)


def _anchors(pts, image_xyz, intr, poses, window):
    """Window corners from the JAX projection, as unproject.py:233-234."""
    h, w = image_xyz.shape[2:4]
    u, v = jax_project(jnp.asarray(pts), jnp.asarray(intr), jnp.asarray(poses))
    iu0 = window_anchors(torch.from_numpy(np.array(u)), w, window)
    iv0 = window_anchors(torch.from_numpy(np.array(v)), h, window)
    np.testing.assert_array_equal(
        iu0.numpy(), np.clip(np.round(np.asarray(u)).astype(np.int32) - window // 2, 0, w - window)
    )
    return iu0.contiguous(), iv0.contiguous()


def _selected_d2(idx, image_xyz, pts):
    flat = np.asarray(image_xyz, np.float64).reshape(-1, 3)
    return ((flat[np.asarray(idx)[0]] - pts[0][:, None].astype(np.float64)) ** 2).sum(-1)


@pytest.mark.parametrize("window,k", [(7, 3), (5, 4)])
def test_k2_plain_f32_matches_jax_minext(window, k):
    pts, depth, intr, poses = _scene()
    image_xyz = np.array(jax_unproject(*map(jnp.asarray, (depth, intr, poses)))[0])
    want = np.asarray(jax_pixel_knn(
        *map(jnp.asarray, (pts, image_xyz, intr, poses)), k, window=window, method="minext"))
    iu0, iv0 = _anchors(pts, image_xyz, intr, poses, window)
    got = k2.pixel_topk(torch.from_numpy(pts), torch.from_numpy(image_xyz), iu0, iv0, window, k).numpy()
    assert got.shape == want.shape == (1, pts.shape[1], k) and got.dtype == np.int32
    differ = np.nonzero((got != want).any(-1))[0]
    if len(differ):  # only exact-tie reorderings may differ
        dg = _selected_d2(got, image_xyz, pts)[differ]
        dw = _selected_d2(want, image_xyz, pts)[differ]
        np.testing.assert_allclose(np.sort(dg, -1), np.sort(dw, -1), rtol=TIE_REL_F32)
    assert len(differ) <= 0.01 * pts.shape[1]
    # the port's own projection gives the same association
    full = points_to_pixel_knn_projective(
        *map(torch.from_numpy, (pts, image_xyz, intr, poses)), k, window=window
    ).numpy()
    assert (full == got).all(-1).mean() >= 0.99


def test_k2_plain_bf16_matches_tpu_kernel():
    pts, depth, intr, poses = _scene(seed=5, n=256)
    window, k = 7, 3
    image_xyz = np.array(jax_unproject(*map(jnp.asarray, (depth, intr, poses)))[0])
    img_bf16 = torch.from_numpy(image_xyz).to(torch.bfloat16)
    iu0, iv0 = _anchors(pts, image_xyz, intr, poses, window)
    got = k2.pixel_topk(torch.from_numpy(pts), img_bf16, iu0, iv0, window, k).numpy()
    # the TPU kernel, driven as tests/test_pixel_select.py drives it
    b, v, h, w, _ = image_xyz.shape
    ww = window * window
    img = jnp.asarray(image_xyz).astype(jnp.bfloat16)
    planar = jnp.transpose(img, (0, 1, 4, 2, 3)).reshape(b * v * 3, h, w)
    hp, wp = h - window + 1, w - window + 1
    pt = jnp.stack([planar[:, dy:dy + hp, dx:dx + wp]
                    for dy in range(window) for dx in range(window)], axis=1)
    patches = pt.reshape(b * v, 3, ww, hp, wp).transpose(0, 3, 4, 1, 2).reshape(-1, 3 * ww)
    ju0, jv0 = jnp.asarray(iu0.numpy()), jnp.asarray(iv0.numpy())
    base = (jnp.arange(b * v, dtype=jnp.int32) * (hp * wp)).reshape(b, v, 1)
    rows = jnp.take(patches, (jv0 * wp + ju0 + base).transpose(0, 2, 1).reshape(-1), axis=0)
    want = np.asarray(pixel_topk_indices(
        jnp.asarray(pts), rows.reshape(b, -1, v * 3 * ww),
        ((jv0 << 16) | ju0).transpose(0, 2, 1), v, window, h, w, k, interpret=True))
    cand = img_bf16.float().numpy()
    np.testing.assert_allclose(
        _selected_d2(got, cand, pts), _selected_d2(want, cand, pts), rtol=BF16_SEL_REL, atol=0
    )


def test_k2_wrapper_raises_on_kernel_misuse():
    pts = torch.zeros(1, 4, 3)
    img = torch.zeros(1, 2, 8, 8, 3)
    iu = torch.zeros(1, 2, 4, dtype=torch.int32)
    k2.check_args(pts, img, iu, iu, 3, 3)
    k2.check_args(pts, img.to(torch.bfloat16), iu, iu, 3, 3)
    with pytest.raises(TypeError):
        k2.check_args(pts, img.half(), iu, iu, 3, 3)
    with pytest.raises(TypeError):
        k2.check_args(pts, img, iu.long(), iu, 3, 3)
    with pytest.raises(ValueError):
        k2.check_args(pts, img, iu[:, :1].contiguous(), iu, 3, 3)
    with pytest.raises(ValueError):
        k2.check_args(pts, img, iu, iu, 9, 3)
    with pytest.raises(ValueError):
        k2.pixel_topk(pts, img, iu, iu, 1, 3)  # k > V·window²
    with pytest.raises(ValueError, match="unsupported device"):
        k2.pixel_topk(*(t.to("meta") for t in (pts, img, iu, iu)), 3, 3)


def test_conv_transpose_kernel_flip():
    """flax ConvTranspose (transpose_kernel=False) == torch ConvTranspose2d
    with the kernel's spatial axes flipped — what convert.py does."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    layer = fnn.ConvTranspose(4, (2, 2), strides=(2, 2))
    variables = perturb(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(layer.apply(variables, jnp.asarray(x)))
    mod = ConvTranspose2d(3, 4, 2, stride=2)
    load_jax_variables(mod, variables)
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    kernel = np.asarray(variables["params"]["kernel"])
    assert not np.allclose(mod.weight.detach().numpy(), kernel.transpose(2, 3, 0, 1))


@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
def test_unet_matches_jax(dtype, rel):
    rng = np.random.RandomState(1)
    images = rng.rand(2, 24, 40, 3).astype(np.float32)  # pad-to-16 and crop
    jnet = JaxUNet(num_classes=5, dtype=jnp.dtype(dtype))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(images))
    init = np.random.RandomState(0)
    variables = perturb(jax.tree.map(
        lambda s: (init.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32),
        shapes))
    want = jax.jit(jnet.apply)(variables, jnp.asarray(images))
    net = UNetResNet34(5, dtype=getattr(torch, dtype))
    load_jax_variables(net, variables)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(images))
    assert got["feature"].dtype == getattr(torch, dtype)
    assert got["feature"].shape == (2, 24, 40, 64) and got["seg_logit"].shape == (2, 24, 40, 5)
    assert_close_rel(got["feature"].float(), np.asarray(want["feature"], np.float32), rel)
    assert_close_rel(got["seg_logit"], np.asarray(want["seg_logit"], np.float32), rel)


@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
def test_feature_aggregation_matches_jax(dtype, rel):
    rng = np.random.RandomState(2)
    src = rng.rand(2, 50, 3, 3).astype(np.float32)
    tgt = rng.rand(2, 50, 3).astype(np.float32)
    feat = rng.randn(2, 50, 3, 64).astype(np.float32)
    jmod = JaxFeatureAggregation(64, dtype=jnp.dtype(dtype))
    args = tuple(map(jnp.asarray, (src, tgt, feat)))
    variables = perturb(jmod.init(jax.random.PRNGKey(0), *args))
    want = np.asarray(jmod.apply(variables, *args))
    mod = FeatureAggregation(64, dtype=getattr(torch, dtype))
    load_jax_variables(mod, variables)
    with torch.no_grad():
        got = mod.eval()(*map(torch.from_numpy, (src, tgt, feat)))
    assert got.dtype == torch.float32
    assert_close_rel(got, want, rel)
