"""PyTorch port: the MVPNet path's chunk datasets
(``mvkpconv_tpu_torch/data/chunks.py``) against the JAX package's numpy
original: ``ChunkDataset`` batches (training, with and without views,
colors as features), the sliding chunks of a scene, ``Frames2DDataset``
batches and its ordered sweep, and the greedy frame choice. Both run the
same numpy from the same seed, both on their host ops' numpy fallbacks
(each native library switched off); equality is exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from mvkpconv_tpu.data import chunks as jax_chunks  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu_torch.data import chunks, synthetic  # noqa: E402
from test_torch_data import assert_same, numpy_fallbacks, scenes  # noqa: E402,F401
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)


@pytest.mark.parametrize("views", [True, False])
def test_chunk_dataset_batches_match_jax(views, numpy_fallbacks):  # noqa: F811
    kw = dict(num_points=512, num_views=2, use_color_feature=not views, seed=3)
    got_ds = chunks.ChunkDataset(scenes(synthetic, views=views), **kw)
    want_ds = jax_chunks.ChunkDataset(scenes(jax_synthetic, views=views), **kw)
    assert_same(got_ds.rgbd_overlap, want_ds.rgbd_overlap, "overlap")
    for i in range(3):
        assert_same(got_ds.sample_batch(2), want_ds.sample_batch(2), f"batch {i}")


def test_sliding_chunks_match_jax(numpy_fallbacks):  # noqa: F811
    got = chunks.SlidingChunks(chunks.ChunkDataset(scenes(synthetic, 1), num_points=256,
                                                   training=False), stride=1.0)
    want = jax_chunks.SlidingChunks(jax_chunks.ChunkDataset(scenes(jax_synthetic, 1), num_points=256,
                                                            training=False), stride=1.0)
    got_c, want_c = list(got.scene_chunks(0)), list(want.scene_chunks(0))
    assert len(got_c) == len(want_c) > 4
    assert_same(got_c, want_c, "chunks")


def test_frames_2d_dataset_matches_jax():
    got = chunks.Frames2DDataset(scenes(synthetic), training=True, seed=5)
    want = jax_chunks.Frames2DDataset(scenes(jax_synthetic), training=True, seed=5)
    assert len(got) == len(want) == 12
    for i in range(3):
        assert_same(got.sample_batch(4), want.sample_batch(4), f"batch {i}")
    got = chunks.Frames2DDataset(scenes(synthetic), training=False)
    want = jax_chunks.Frames2DDataset(scenes(jax_synthetic), training=False)
    # the ordered sweep wraps its last batch and says how many rows are real
    assert_same(list(got.iter_batches(5)), list(want.iter_batches(5)), "sweep")
    assert [c for _, c in got.iter_batches(5)] == [5, 5, 2]


def test_select_frames_greedy_matches_jax(rng):
    overlap = rng.rand(9, 300) < 0.3
    inside = np.flatnonzero(rng.rand(300) < 0.5)
    assert_same(chunks.select_frames_greedy(overlap, inside, 4),
                jax_chunks.select_frames_greedy(overlap, inside, 4))
