"""PyTorch port: the native C++ host ops (``mvkpconv_tpu_torch/data/native.py``
over ``csrc/host_ops.cpp``) and the budget calibration
(``data/calibration.py``) against the JAX package's.

  * the port's C++ source is ``native/host_ops.cpp`` byte for byte;
  * the two libraries (the same source, the same compiler) give equal
    voxel subsamples and 1-NN results, and the port's agrees with its numpy
    fallback as the JAX package's does (``tests/test_native.py``): the same
    voxels as a set, barycentres within 1e-5, majority labels, exact 1-NN;
  * a ``SphereDataset`` with both native libraries on gives JAX's batches,
    potentials and in-sphere counts exactly;
  * ``calibrate_budgets`` gives JAX's dict from the same dataset seed.

Skips where ``g++`` is missing (the libraries cannot be built), as
``tests/test_native.py`` does.
"""

import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from mvkpconv_tpu.data import native as jax_native  # noqa: E402
from mvkpconv_tpu.data import spheres as jax_spheres  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu.data.calibration import calibrate_budgets as jax_calibrate  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch.data import native, spheres, synthetic  # noqa: E402
from mvkpconv_tpu_torch.data.calibration import calibrate_budgets  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from test_torch_data import SMALL, assert_same  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)


@pytest.fixture
def libraries():
    if shutil.which("g++") is None:
        pytest.skip("g++ missing: the native host ops cannot be built")
    assert native.available() and jax_native.available()


def test_port_source_is_the_original():
    assert native._SRC.read_bytes() == (native._PKG.parent / "native" / "host_ops.cpp").read_bytes()


def sorted_rows(*arrays):
    """Rows of the column-stacked arrays in lexicographic order."""
    cat = np.concatenate([np.asarray(a, np.float64).reshape(len(a), -1) for a in arrays], 1)
    return cat[np.lexsort(cat.T[::-1])]


def test_native_ops_match_jax_and_numpy(libraries, rng):
    pts = (rng.rand(20000, 3) * 4).astype(np.float32)
    cols = rng.rand(20000, 3).astype(np.float32)
    labs = rng.randint(-1, 20, 20000).astype(np.int32)
    got = native.grid_subsample_native(pts, cols, labs, 0.25)
    assert_same(got, jax_native.grid_subsample_native(pts, cols, labs, 0.25), "subsample")
    # against the numpy fallback: the same voxels, in another order
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_load", lambda: None)
        want = spheres.grid_subsample_np(pts, cols, labs, 0.25)
    assert len(got[0]) == len(want[0])
    g, w = sorted_rows(got[0], got[1], got[2]), sorted_rows(want[0], want[1], want[2])
    np.testing.assert_allclose(g[:, :6], w[:, :6], atol=1e-5)
    assert (g[:, 6] == w[:, 6]).mean() > 0.9  # majority labels (ties broken in another order)

    supports = (rng.rand(3000, 3) * 5).astype(np.float32)
    queries = (rng.rand(500, 3) * 5).astype(np.float32)
    far = (rng.rand(8, 3) * 0.5 + 6).astype(np.float32)  # the ring expansion
    for q, cell in ((queries, None), (queries, 0.1), (far, 0.1)):
        idx, d2 = native.nearest_neighbor_1nn_native(q, supports, cell)
        assert_same((idx, d2), jax_native.nearest_neighbor_1nn_native(q, supports, cell), "1-NN")
        brute = ((q[:, None] - supports[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(idx, brute.argmin(1))


def test_majority_labels_and_mean_features(libraries):
    pts = np.repeat(np.array([[0.1, 0.1, 0.1], [3.0, 3.0, 3.0]], np.float32), 4, 0)
    cols = np.arange(8, dtype=np.float32).reshape(8, 1).repeat(3, 1)
    labs = np.array([2, 2, 5, 2, 7, 7, 7, -1], np.int32)
    g_pts, g_cols, g_labs = native.grid_subsample_native(pts, cols, labs, 0.5)
    assert g_labs.tolist() == [2, 7] and g_cols[:, 0].tolist() == [1.5, 5.5]


def test_sphere_dataset_on_native_ops_matches_jax(libraries):
    """The 3D-only baseline's training batches (the scenes' voxel subsample
    through the native op), and the frame-overlap matrix (the native 1-NN)."""
    kw = dict(SMALL, fusion="none", in_features_dim=5, augment_color=0.5)
    scenes = [synthetic.make_scene(seed=s, num_points=6000) for s in (0, 1)]
    jscenes = [jax_synthetic.make_scene(seed=s, num_points=6000) for s in (0, 1)]
    ds = spheres.SphereDataset(scenes, KPConfig(**kw), training=True, seed=7)
    jds = jax_spheres.SphereDataset(jscenes, JaxConfig(**kw), training=True, seed=7)
    for i in range(2):
        assert_same(ds.sample_batch(), jds.sample_batch(), f"batch {i}")
    assert_same(ds.potentials, jds.potentials, "potentials")
    assert ds.sphere_counts == jds.sphere_counts

    # the frame-overlap 1-NN on 256 base points: the dataset takes 2,048,
    # and JAX's ring search at 0.1 m cells takes about a second a frame
    # for them; the port's, at the library's own cell, the same distances
    scene = synthetic.make_scene(seed=3, num_points=4000)
    scene.update(synthetic.render_views(scene, 3, 24, 32, seed=3))
    jscene = jax_synthetic.make_scene(seed=3, num_points=4000)
    jscene.update(jax_synthetic.render_views(jscene, 3, 24, 32, seed=3))
    got = spheres.compute_rgbd_overlap(scene, np.random.RandomState(2), n_base=256)
    assert_same(got, jax_spheres.compute_rgbd_overlap(jscene, np.random.RandomState(2), n_base=256), "overlap")
    assert 0 < got[1].mean() < 1


def test_calibrate_budgets_matches_jax(libraries):
    """``tests/test_calibration.py``'s configuration and scene."""
    kw = dict(
        architecture=("simple", "resnetb_strided", "resnetb", "resnetb_strided", "resnetb",
                      "nearest_upsample", "unary", "nearest_upsample", "unary"),
        num_points=(2048, 512, 128), conv_neighbors=(16, 16, 16), pool_neighbors=(16, 16),
        in_radius=1.0, first_subsampling_dl=0.06, in_features_dim=2,
    )
    ds = spheres.SphereDataset([synthetic.make_scene(seed=0, num_points=20000)], KPConfig(**kw),
                               training=False, seed=0)
    jds = jax_spheres.SphereDataset([jax_synthetic.make_scene(seed=0, num_points=20000)], JaxConfig(**kw),
                                    training=False, seed=0)
    got = calibrate_budgets(ds, num_spheres=4)
    assert got == jax_calibrate(jds, num_spheres=4)
    assert len(got["num_points"]) == 3 and got["num_points"][0] % 256 == 0
    assert KPConfig(**kw).replace(**got).pyramid_spec().num_points == got["num_points"]
