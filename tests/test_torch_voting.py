"""PyTorch port: evaluation (``mvkpconv_tpu_torch/eval/``) against the JAX
package's, on the same oracle ``predict_fn``.

Both packages sample the same sphere batches from the same scenes and seed
(both on their numpy host ops, each native library switched off), and
both are given one numpy function of the batch as the model: so the
probability buffers, the potentials, the confusion and every score must be
equal exactly, for the training-time ``validation_sweep`` and for the
voting ``VotingTester`` (subsampled and full-resolution scores, PLY
artifacts).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from mvkpconv_tpu.data import native as jax_native  # noqa: E402
from mvkpconv_tpu.data import spheres as jax_spheres  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu.eval import evaluator as jax_evaluator  # noqa: E402
from mvkpconv_tpu.eval import voting as jax_voting  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch.data import native, spheres, synthetic  # noqa: E402
from mvkpconv_tpu_torch.eval import evaluator, voting  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402

CFG = dict(
    fusion="none", in_features_dim=2, num_points=(256, 64), first_subsampling_dl=0.1,
    in_radius=1.0, batch_num=2,
)


def oracle(batch):
    """(B, N0, 20) probabilities: the labels' class favoured, with a
    point-dependent share for the others, so some points come out wrong."""
    labels = np.clip(batch["labels"], 0, 19)
    logits = np.sin(batch["points"] @ np.arange(60, dtype=np.float32).reshape(3, 20))
    logits += 1.2 * np.eye(20, dtype=np.float32)[labels]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def datasets(monkeypatch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)
    scenes = [synthetic.make_scene(seed=s, num_points=6000) for s in (100, 101)]
    jscenes = [jax_synthetic.make_scene(seed=s, num_points=6000) for s in (100, 101)]
    return (spheres.SphereDataset(scenes, KPConfig(**CFG), training=False, seed=1),
            jax_spheres.SphereDataset(jscenes, JaxConfig(**CFG), training=False, seed=1),
            scenes)


def test_validation_sweep_matches_jax(monkeypatch, tmp_path):
    ds, jds, _ = datasets(monkeypatch)
    proportions = np.linspace(1.0, 2.0, 20)
    got = voting.validation_sweep(ds, oracle, 20, num_batches=3, val_proportions=proportions,
                                  artifact_dir=tmp_path / "port")
    want = jax_voting.validation_sweep(jds, oracle, 20, num_batches=3, val_proportions=proportions,
                                       artifact_dir=tmp_path / "jax")
    assert got["miou"] == want["miou"] and 0 < got["miou"] < 1
    np.testing.assert_array_equal(got["class_iou"], want["class_iou"])
    for name in ("scene000_pred.ply", "scene001_potentials.ply"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_voting_tester_matches_jax(monkeypatch, tmp_path):
    """A sweep to 0.5 votes (prefetch thread on): equal probability buffers,
    potentials, batches swept, scores and table, full-resolution scores by
    1-NN reprojection, and PLY artifacts."""
    ds, jds, scenes = datasets(monkeypatch)
    calls = {"port": 0, "jax": 0}

    def counted(side):
        def predict(batch):
            calls[side] += 1
            return oracle(batch)
        return predict

    tester = voting.VotingTester(ds, counted("port"), 20, num_votes=0.5)
    jtester = jax_voting.VotingTester(jds, counted("jax"), 20, num_votes=0.5)
    ev, jev = tester.run(), jtester.run()
    assert calls["port"] == calls["jax"] > 1
    for got, want in zip(tester.probs, jtester.probs):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ds.potentials, jds.potentials):
        np.testing.assert_array_equal(got, want)
    assert ds.min_potential() >= 0.5
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    assert ev.miou == jev.miou and ev.overall_accuracy == jev.overall_accuracy
    assert ev.table() == jev.table()
    full, jfull = tester.score_reprojected(scenes), jtester.score_reprojected(scenes)
    np.testing.assert_array_equal(full.confusion, jfull.confusion)
    assert full.confusion.sum() > ev.confusion.sum()
    tester.save_artifacts(tmp_path / "port", prefix="t_")
    jtester.save_artifacts(tmp_path / "jax", prefix="t_")
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(names) == 4
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_evaluator_matches_jax(rng):
    pred, label = rng.randint(0, 25, 500), rng.randint(-1, 20, 500)
    ev, jev = evaluator.Evaluator(), jax_evaluator.Evaluator()
    for e in (ev, jev):
        e.update(pred, label)
        e.update(pred[::-1], label)
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    np.testing.assert_array_equal(ev.class_iou, jev.class_iou)
    np.testing.assert_array_equal(ev.class_accuracy, jev.class_accuracy)
    assert ev.miou == jev.miou and ev.overall_accuracy == jev.overall_accuracy
    assert ev.table() == jev.table()
