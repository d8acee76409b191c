"""PyTorch port: the host-side tools of the dataset workflow against the
JAX package's, on the JAX tests' fixtures (``tests/test_tools.py``,
``test_eval.py``, ``test_misc_models.py``, ``test_data.py``,
``test_observability.py``):

  * ``preprocess``: the same pickle and the same class-weights file;
  * ``evaluate_labels``: the same table text, with and without ``--nyu40``;
  * ``inspect_dataset``: the same JSON report with its timings removed, a
    starved budget flagged and ``--strict`` exiting in both;
  * ``plot_convergence``: the same text summary; without matplotlib the
    port prints the summary alone and raises where ``--output`` asks for the
    plot;
  * ``utils/html_viewer.py``: the same HTML bytes for the same arrays
    (``save_html_viewer``, ``prediction_viewer_html``), and
    ``VotingTester.save_artifacts(html=True)`` the same viewer files.

Both packages run the same numpy; equality is exact.
"""

import builtins
import json
import pickle

import numpy as np
import pytest

pytest.importorskip("jax")

from mvkpconv_tpu.data import spheres as jax_spheres  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu.eval import voting as jax_voting  # noqa: E402
from mvkpconv_tpu.tools import evaluate_labels as jax_evaluate_labels  # noqa: E402
from mvkpconv_tpu.tools import inspect_dataset as jax_inspect_dataset  # noqa: E402
from mvkpconv_tpu.tools import plot_convergence as jax_plot_convergence  # noqa: E402
from mvkpconv_tpu.tools import preprocess as jax_preprocess  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.utils import html_viewer as jax_html  # noqa: E402
from mvkpconv_tpu_torch.data import meta, spheres, synthetic  # noqa: E402
from mvkpconv_tpu_torch.eval import voting  # noqa: E402
from mvkpconv_tpu_torch.tools import evaluate_labels, inspect_dataset, plot_convergence, preprocess  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.utils import html_viewer  # noqa: E402
from test_torch_data import assert_same  # noqa: E402
from test_torch_io import same_module_body, write_scan  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)


def run_both(capsys, port_main, jax_main, port_argv, jax_argv=None):
    """(port's return, port's stdout, JAX's stdout)."""
    got = port_main(port_argv)
    port_out = capsys.readouterr().out
    jax_main(jax_argv if jax_argv is not None else port_argv)
    return got, port_out, capsys.readouterr().out


def test_preprocess_writes_the_same_split_and_weights(tmp_path, rng, capsys):
    write_scan(tmp_path, rng, "scene0001_00", 60)
    write_scan(tmp_path, rng, "scene0002_00", 40)
    split = tmp_path / "split.txt"
    split.write_text("scene0001_00\n\nscene0002_00\n")

    def argv(side):
        return ["--scans", str(tmp_path), "--split-file", str(split), "--output", str(tmp_path / f"{side}.pkl"),
                "--weights-output", str(tmp_path / f"{side}_w.txt"), "--verbose"]

    scenes, port_out, jax_out = run_both(capsys, preprocess.main, jax_preprocess.main, argv("port"), argv("jax"))
    assert port_out.replace("port", "jax") == jax_out
    assert len(scenes) == 2
    assert_same(pickle.loads((tmp_path / "port.pkl").read_bytes()),
                pickle.loads((tmp_path / "jax.pkl").read_bytes()), "split")
    assert (tmp_path / "port_w.txt").read_bytes() == (tmp_path / "jax_w.txt").read_bytes()
    assert np.loadtxt(tmp_path / "port_w.txt").shape == (20,)


@pytest.mark.parametrize("nyu40", [False, True])
def test_evaluate_labels_prints_the_same_table(tmp_path, rng, capsys, nyu40):
    pred_d, gt_d = tmp_path / "pred", tmp_path / "gt"
    pred_d.mkdir(), gt_d.mkdir()
    ids = np.array([0, 1, 2, 3, 4, 5, 39, 40, 41, -1]) if nyu40 else np.arange(-1, 6)
    for scan in ("scene0", "scene1"):
        gt = rng.choice(ids, 200)
        pred = np.where(rng.rand(200) < 0.2, rng.choice(ids, 200), gt)
        np.savetxt(pred_d / f"{scan}.txt", pred, fmt="%d")
        np.savetxt(gt_d / f"{scan}.txt", gt, fmt="%d")
    argv = ["--pred-path", str(pred_d), "--gt-path", str(gt_d)] + (["--nyu40"] if nyu40 else ["--num-classes", "6"])
    ev, port_out, jax_out = run_both(capsys, evaluate_labels.main, jax_evaluate_labels.main, argv)
    assert port_out == jax_out and "scored scene1.txt" in port_out
    assert ev.table() in port_out and 0 < ev.miou < 1


def test_inspect_dataset_writes_the_same_report(tmp_path, capsys):
    cfg = dict(num_points=(1024, 256), conv_neighbors=(2, 12), pool_neighbors=(12,),
               architecture=("simple", "resnetb_strided", "nearest_upsample", "unary"), in_radius=1.0,
               first_subsampling_dl=0.06, in_features_dim=2, fusion="none", num_views=3,
               image_height=24, image_width=32)
    path = tmp_path / "params.txt"
    KPConfig(**cfg).save(path)

    def argv(side):
        return ["--data", "synthetic:1", "--config", str(path), "--spheres", "3", "--output", str(tmp_path / side)]

    report, port_out, jax_out = run_both(capsys, inspect_dataset.main, jax_inspect_dataset.main,
                                         argv("port"), argv("jax"))
    timings = ("setup_s", "stage_ms", "spheres_per_sec_single_thread")
    got = json.loads((tmp_path / "port" / "inspect_dataset.json").read_text())
    want = json.loads((tmp_path / "jax" / "inspect_dataset.json").read_text())
    assert sorted(got["stage_ms"]) == sorted(want["stage_ms"])
    assert {k: v for k, v in got.items() if k not in timings} == {k: v for k, v in want.items() if k not in timings}
    conv0 = next(r for r in report["budgets"] if r["kind"] == "conv" and r["level"] == 0)
    assert not conv0["ok"] and "MISCALIBRATED" in port_out and "MISCALIBRATED" in jax_out
    with pytest.raises(SystemExit):
        inspect_dataset.main(argv("strict") + ["--strict"])


def write_training_txt(run):
    run.mkdir()
    lines = ["epochs steps out_loss offset_loss train_accuracy time"]
    for s in range(30):
        lines.append(f"0 {s + 1} {3.0 - 0.05 * s + 0.1 * np.sin(s):.3f} 0.000 {0.2 + 0.02 * s:.3f} {s * 0.5:.1f}")
    (run / "training.txt").write_text("\n".join(lines) + "\n")


def test_plot_convergence_prints_the_same_summary(tmp_path, capsys, monkeypatch):
    for name in ("run1", "run2"):
        write_training_txt(tmp_path / name)
    runs = [str(tmp_path / "run1"), str(tmp_path / "run2")]
    curves, port_out, jax_out = run_both(capsys, plot_convergence.main, jax_plot_convergence.main,
                                         runs + ["--output", str(tmp_path / "port.png")],
                                         runs + ["--output", str(tmp_path / "jax.png")])
    summary = [ln for ln in port_out.splitlines() if not ln.startswith("wrote")]
    assert summary == [ln for ln in jax_out.splitlines() if not ln.startswith("wrote")]
    assert "30 steps" in summary[0] and sorted(curves) == runs
    # without matplotlib (the card's machine is not known to have it)
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    plot_convergence.main(runs)
    out = capsys.readouterr().out.splitlines()
    assert out == summary + ["matplotlib is not installed: text summary only"]
    with pytest.raises(ImportError, match="needs matplotlib"):
        plot_convergence.main(runs + ["--output", str(tmp_path / "c.png")])


def test_html_viewer_writes_the_same_bytes(tmp_path, rng):
    assert same_module_body(html_viewer, jax_html)
    pts = rng.rand(1000, 3).astype(np.float32)
    labels = rng.randint(-1, 5, 1000)
    pred = np.where(rng.rand(1000) < 0.3, rng.randint(0, 5, 1000), labels)
    red = np.tile(np.array([[255, 0, 0]], np.uint8), (30, 1))
    clouds = [{"name": "scene", "points": pts, "labels": labels},
              {"name": "overlay", "points": pts[:30], "colors": red, "size": 3.0, "on": False}]
    for pkg, side in ((html_viewer, "port"), (jax_html, "jax")):
        pkg.save_html_viewer(tmp_path / f"{side}.html", clouds, class_names=meta.CLASS_NAMES, title="t")
        pkg.save_html_viewer(tmp_path / f"{side}_big.html", clouds[:1], max_points=400)
        pkg.prediction_viewer_html(tmp_path / f"{side}_pred.html", pts, pred, labels,
                                   class_names=meta.CLASS_NAMES)
    for name in ("", "_big", "_pred"):
        assert (tmp_path / f"port{name}.html").read_bytes() == (tmp_path / f"jax{name}.html").read_bytes(), name


def test_voting_artifacts_with_html_match_jax(tmp_path, monkeypatch):
    from mvkpconv_tpu.data import native as jax_native
    from mvkpconv_tpu_torch.data import native

    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)
    kw = dict(fusion="none", in_features_dim=2, num_points=(256, 64), first_subsampling_dl=0.1, in_radius=1.0,
              batch_num=2)
    ds = spheres.SphereDataset([synthetic.make_scene(seed=5, num_points=3000)], KPConfig(**kw), training=False)
    jds = jax_spheres.SphereDataset([jax_synthetic.make_scene(seed=5, num_points=3000)], JaxConfig(**kw),
                                    training=False)

    def predict(batch):
        x = np.sin(batch["points"] @ np.arange(60, dtype=np.float32).reshape(3, 20))
        return np.exp(x) / np.exp(x).sum(-1, keepdims=True)

    for tester, side in ((voting.VotingTester(ds, predict, 20, num_votes=0.2), "port"),
                         (jax_voting.VotingTester(jds, predict, 20, num_votes=0.2), "jax")):
        tester.run(max_batches=3)
        tester.save_artifacts(tmp_path / side, html=True, class_names=meta.CLASS_NAMES)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "scene000_viewer.html" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
