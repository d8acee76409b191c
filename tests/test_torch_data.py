"""PyTorch port: the host data pipeline (``mvkpconv_tpu_torch/data/``) and
the PLY writers against the JAX package's numpy modules.

The port's copies must give the same arrays from the same seed: synthetic
scenes of both families, rendered views, ``SphereDataset`` batches (three
in a row, training with augmentation and evaluation, with views) and its
potentials, feature assembly, and the same PLY bytes. Both packages run on
their numpy host ops here (each native library made unavailable for the
test: the native subsample emits voxels in another order than numpy's);
``tests/test_torch_native.py`` holds the two native libraries against each
other. Equality is exact.
"""

import pickle

import numpy as np
import pytest

pytest.importorskip("jax")

from mvkpconv_tpu.data import meta as jax_meta  # noqa: E402
from mvkpconv_tpu.data import native as jax_native  # noqa: E402
from mvkpconv_tpu.data import spheres as jax_spheres  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.utils import visualize as jax_visualize  # noqa: E402
from mvkpconv_tpu_torch.data import meta, spheres, synthetic  # noqa: E402
from mvkpconv_tpu_torch.data import native  # noqa: E402
from mvkpconv_tpu_torch.data.prefetch import prefetch  # noqa: E402
from mvkpconv_tpu_torch.data.scannet_io import load_split  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.utils import visualize  # noqa: E402

# the CLI test size (tests/test_tools.py's TINY) with views
SMALL = dict(
    architecture=("simple", "resnetb_strided", "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(8, 8), pool_neighbors=(8,),
    first_features_dim=16, first_subsampling_dl=0.1, in_radius=1.0,
    batch_num=2, num_views=2, image_height=24, image_width=32,
)


@pytest.fixture
def numpy_fallbacks(monkeypatch):
    """Both packages' host ops without their native libraries."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)


def assert_same(got, want, what=""):
    assert type(got) is type(want), (what, type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)


def scenes(pkg, n=2, views=True):
    out = []
    for s in range(n):
        scene = pkg.make_scene(seed=s, num_points=6000)
        if views:
            scene.update(pkg.render_views(scene, 6, 24, 32, seed=s))
        out.append(scene)
    return out


def test_meta_matches_jax():
    for name in ("CLASS_NAMES", "NUM_CLASSES", "NYU40_EVAL_IDS", "SCANNET_COLOR_PALETTE"):
        assert getattr(meta, name) == getattr(jax_meta, name), name


@pytest.mark.parametrize("family", ["boxes", "curved"])
def test_make_scene_and_views_match_jax(family):
    got = synthetic.make_scene(seed=3, num_points=5000, family=family)
    want = jax_synthetic.make_scene(seed=3, num_points=5000, family=family)
    assert_same(got, want, family)
    assert_same(synthetic.render_views(got, 3, 24, 32, seed=3),
                jax_synthetic.render_views(want, 3, 24, 32, seed=3), "views")
    assert_same(synthetic.make_intrinsics(24, 32, 50.0), jax_synthetic.make_intrinsics(24, 32, 50.0))


@pytest.mark.parametrize("base_dim", [1, 2, 4, 5, 7])
def test_assemble_features_matches_jax(base_dim, rng):
    pts, cols = rng.rand(50, 3).astype(np.float32), rng.rand(50, 3).astype(np.float32)
    for use_color in (True, False):
        assert_same(spheres.assemble_features(pts, cols, base_dim, use_color),
                    jax_spheres.assemble_features(pts, cols, base_dim, use_color))


@pytest.mark.parametrize("mode", ["train", "eval", "train-baseline"])
def test_sphere_dataset_matches_jax(mode, numpy_fallbacks):
    """Three batches in a row (host-only keys included), the potentials and
    the in-sphere counts after them: training (augmentation, pose
    composition, color drop) and evaluation, with views; and the 3D-only
    baseline's features (no views)."""
    training = mode.startswith("train")
    if mode.endswith("baseline"):
        kw = dict(SMALL, fusion="none", in_features_dim=5, augment_color=0.5)
    else:
        kw = dict(SMALL, fusion="early", in_features_dim=66)
    views = not mode.endswith("baseline")
    ds = spheres.SphereDataset(scenes(synthetic, views=views), KPConfig(**kw), training, seed=7)
    jds = jax_spheres.SphereDataset(scenes(jax_synthetic, views=views), JaxConfig(**kw), training, seed=7)
    for i in range(3):
        assert_same(ds.sample_batch(), jds.sample_batch(), f"batch {i}")
    assert_same(ds.potentials, jds.potentials, "potentials")
    assert_same(ds.pot_points, jds.pot_points, "pot_points")
    assert ds.sphere_counts == jds.sphere_counts
    assert sorted(ds.stage_times) == sorted(jds.stage_times)
    assert ds.min_potential() == jds.min_potential()
    batch = spheres.device_batch(ds.sample_batch())
    assert not set(spheres.HOST_ONLY_KEYS) & set(batch)
    assert batch["points"].shape == (2, 256, 3)


def test_prefetch_keeps_order_and_passes_errors():
    assert list(prefetch(iter(range(50)), depth=3)) == list(range(50))

    def failing():
        yield 1
        yield 2
        raise KeyError("producer fault")

    it = prefetch(failing(), depth=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="producer fault"):
        next(it)


def test_load_split_reads_a_pickled_split(tmp_path):
    split = scenes(synthetic, n=1, views=False)
    path = tmp_path / "split.pkl"
    path.write_bytes(pickle.dumps(split))
    assert_same(load_split(path), split)


def test_ply_writers_match_jax_bytes(tmp_path, rng):
    pts = rng.rand(40, 3).astype(np.float32)
    pred = rng.randint(0, 20, 40)
    labels = rng.randint(-1, 20, 40).astype(np.int32)
    for name, args in (("pred", (pts, pred, labels)), ("pred_nolabels", (pts, pred))):
        visualize.save_prediction_ply(tmp_path / f"{name}.ply", *args)
        jax_visualize.save_prediction_ply(tmp_path / f"{name}_jax.ply", *args)
        assert (tmp_path / f"{name}.ply").read_bytes() == (tmp_path / f"{name}_jax.ply").read_bytes()
    pots = rng.rand(40)
    visualize.save_potentials_ply(tmp_path / "pots.ply", pts, pots)
    jax_visualize.save_potentials_ply(tmp_path / "pots_jax.ply", pts, pots)
    assert (tmp_path / "pots.ply").read_bytes() == (tmp_path / "pots_jax.ply").read_bytes()
