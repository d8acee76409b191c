"""PyTorch port: the mvpnet fork's 2D tools and CLIs.

Against the JAX package: ``eval/eval2d.evaluate_frames`` (the same IoUs on
the same probabilities), ``utils/visualize.save_2d_panel`` (the PNG the
port writes with the standard library decodes to the pixels of JAX's PIL
panel), ``models/unet2d.load_torch_resnet34_encoder`` (on a random
torchvision-shaped ``state_dict``: the same UNet as JAX's loader gives,
through ``convert.py``'s UNet-alone walk). The five CLIs end to end on
``--device cpu`` at the JAX CLI tests' tiny sizes (``tests/test_tools.py``,
``tests/test_misc_models.py``): ``train_2d`` → ``test_2d`` (reproducing the
trainer's last ``val_miou`` within 1e-6), ``train_mvpnet`` → ``test_mvpnet``,
``--no-images``, ``precompute_2d``; without ``--device`` on a host without a
card each raises before it loads anything. The JAX CLIs beside the port's
(the same files and logs) are ``-m slow``.
"""

import json
import pickle

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from mvkpconv_tpu.data import chunks as jax_chunks  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu.eval.eval2d import evaluate_frames as jax_evaluate_frames  # noqa: E402
from mvkpconv_tpu.models.unet2d import RESNET34_LAYERS  # noqa: E402
from mvkpconv_tpu.models.unet2d import UNetResNet34 as JaxUNet  # noqa: E402
from mvkpconv_tpu.models.unet2d import load_torch_resnet34_encoder as jax_load_encoder  # noqa: E402
from mvkpconv_tpu.utils import visualize as jax_visualize  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.data import chunks, synthetic  # noqa: E402
from mvkpconv_tpu_torch.eval.eval2d import evaluate_frames  # noqa: E402
from mvkpconv_tpu_torch.models.unet2d import UNetResNet34, load_torch_resnet34_encoder  # noqa: E402
from mvkpconv_tpu_torch.tools import precompute_2d, test_2d, test_mvpnet, train_2d, train_mvpnet  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.utils import visualize  # noqa: E402
from test_torch_cli import TINY  # noqa: E402
from test_torch_data import scenes  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402


def test_evaluate_frames_matches_jax():
    """The same probabilities (a seeded function of each batch's images)
    give the same confusion and IoUs; the wrapped rows of the last batch are
    left out."""
    def probs_fn(batch):
        rng = np.random.RandomState(int(batch["images"].sum() * 1000) % 2**31)
        return rng.rand(*batch["labels"].shape, 20).astype(np.float32)

    got = evaluate_frames(probs_fn, chunks.Frames2DDataset(scenes(synthetic), training=False), batch_size=5)
    want = jax_evaluate_frames(probs_fn, jax_chunks.Frames2DDataset(scenes(jax_synthetic), training=False),
                               batch_size=5)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    np.testing.assert_array_equal(got.class_iou, want.class_iou)
    labelled = sum(int((s["label"] != -1).sum()) for s in scenes(synthetic))
    assert got.miou == want.miou and got.confusion.sum() == labelled  # each of the 12 frames once


def test_save_2d_panel_pixels_match_jax(tmp_path, rng):
    image = rng.rand(24, 32, 3).astype(np.float32) * 1.2 - 0.1  # clipped to [0, 1]
    gt = rng.randint(-1, 20, (24, 32))
    pred = rng.randint(0, 20, (24, 32))
    visualize.save_2d_panel(tmp_path / "port" / "p.png", image, gt, pred)
    jax_visualize.save_2d_panel(tmp_path / "jax" / "p.png", image, gt, pred)
    got = np.asarray(Image.open(tmp_path / "port" / "p.png"))
    want = np.asarray(Image.open(tmp_path / "jax" / "p.png"))
    assert got.shape == (24, 96, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert Image.open(tmp_path / "port" / "p.png").mode == "RGB"


def resnet34_state_dict(rng):
    """A random ``state_dict`` with torchvision ResNet34's encoder keys and
    shapes (its weights are a download and are not fetched here)."""
    sd = {}

    def bn(prefix, c):
        sd.update({f"{prefix}.weight": rng.random(c), f"{prefix}.bias": rng.standard_normal(c),
                   f"{prefix}.running_mean": rng.standard_normal(c), f"{prefix}.running_var": rng.random(c) + 0.5,
                   f"{prefix}.num_batches_tracked": np.array(7)})

    sd["conv1.weight"] = rng.standard_normal((64, 3, 7, 7), np.float32)
    bn("bn1", 64)
    cin = 64
    for stage, (filters, depth) in enumerate(RESNET34_LAYERS):
        for i in range(depth):
            t = f"layer{stage + 1}.{i}"
            sd[f"{t}.conv1.weight"] = rng.standard_normal((filters, cin if i == 0 else filters, 3, 3), np.float32)
            bn(f"{t}.bn1", filters)
            sd[f"{t}.conv2.weight"] = rng.standard_normal((filters, filters, 3, 3), np.float32)
            bn(f"{t}.bn2", filters)
            if i == 0 and stage > 0:
                sd[f"{t}.downsample.0.weight"] = rng.standard_normal((filters, cin, 1, 1), np.float32)
                bn(f"{t}.downsample.1", filters)
        cin = filters
    sd["fc.weight"] = rng.standard_normal((1000, 512), np.float32)
    return {k: torch.from_numpy(np.asarray(v, np.float32 if v.ndim else np.int64)) for k, v in sd.items()}


def test_load_torch_resnet34_encoder_matches_jax(tmp_path):
    """On a random state dict (and the same dict saved, under a
    ``'state_dict'`` key): the port's UNet equals JAX's loader's result
    bridged by ``convert.py``, decoder and logit conv untouched."""
    images = np.zeros((1, 24, 32, 3), np.float32)
    shapes = jax.eval_shape(lambda: JaxUNet(6).init(jax.random.PRNGKey(0), images))
    variables = random_variables(shapes, seed=5)
    sd = resnet34_state_dict(np.random.default_rng(0))
    want = load_jax_variables(UNetResNet34(6), jax_load_encoder(variables, sd)).state_dict()
    start = load_jax_variables(UNetResNet34(6), variables).state_dict()
    torch.save({"state_dict": sd}, tmp_path / "r34.pth")
    for source in (sd, tmp_path / "r34.pth"):
        got = load_torch_resnet34_encoder(load_jax_variables(UNetResNet34(6), variables), source).state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert torch.equal(got["encoder0.weight"], sd["conv1.weight"])
    assert torch.equal(got["decoder0.conv.weight"], start["decoder0.conv.weight"])
    bad = dict(sd, **{"layer1.0.conv1.weight": torch.zeros(64, 64, 1, 1)})
    with pytest.raises(ValueError, match="layer1_0.conv1.weight"):
        load_torch_resnet34_encoder(UNetResNet34(6), bad)


def write_config(tmp_path, **kw):
    path = tmp_path / "params.txt"
    KPConfig(**{**TINY, **kw}).save(path)
    return str(path)


def val_mious(run):
    return [rec["value"] for line in (run / "scalars.jsonl").read_text().splitlines()
            if (rec := json.loads(line))["tag"] == "val_miou"]


def test_train_2d_then_test_2d_and_precompute_on_cpu(tmp_path):
    """``train_2d`` 2 steps (a validation sweep at the end, its panel, the
    checkpoints), ``test_2d`` on the same validation scenes
    reproducing the last ``val_miou`` within 1e-6 (one code path), then
    ``precompute_2d`` from the run's checkpoint."""
    run = tmp_path / "run2d"
    trainer = train_2d.main(["--data", "synthetic:1", "--val-data", "synthetic:1", "--config",
                             write_config(tmp_path, epoch_steps=100), "--output", str(run), "--steps", "2",
                             "--device", "cpu"])
    assert trainer.step == 2 and (run / "checkpoints" / "model_best.pt").exists()
    assert (run / "checkpoints" / "last_checkpoint").read_text() == "ckpt_00000002.pt"
    assert (run / "panels" / "step000002.png").exists()
    assert len((run / "val_IoUs.txt").read_text().splitlines()) == len(val_mious(run)) == 1
    ev = test_2d.main(["--run", str(run), "--data", "synthetic:1", "--device", "cpu"])
    assert (run / "test_2d_IoUs.txt").exists()
    np.testing.assert_allclose(ev.miou, val_mious(run)[-1], atol=1e-6)

    cached = precompute_2d.main(["--run", str(run), "--data", "synthetic:1", "--out", str(tmp_path / "f.pkl"),
                                 "--device", "cpu"])
    with open(tmp_path / "f.pkl", "rb") as f:
        saved = pickle.load(f)
    assert len(saved) == len(cached) == 1 and "rgb" not in saved[0]
    feat = saved[0]["feature_2d3d"]
    assert feat.shape == (len(saved[0]["points"]), 64) and np.isfinite(feat).all() and np.abs(feat).max() > 0


def test_train_mvpnet_then_test_mvpnet_on_cpu(tmp_path):
    """MVPNet 2 steps at 512 points (the published PN2SSG widths, 2048
    centroids: the FPS takes every point, then index 0) and its final
    4-batch validation, the sliding-chunk test of its checkpoint, and the
    3D-only baseline (``--no-images``)."""
    cfg = write_config(tmp_path, epoch_steps=100)
    run = tmp_path / "mvp"
    trainer = train_mvpnet.main(["--data", "synthetic:1", "--val-data", "synthetic:1", "--config", cfg,
                                 "--output", str(run), "--steps", "2", "--num-points", "512",
                                 "--num-views", "2", "--device", "cpu"])
    assert trainer.step == 2 and trainer.model.freeze_2d and not trainer.model.net_2d.training
    assert (run / "checkpoints" / "last_checkpoint").read_text() == "ckpt_00000002.pt"
    assert len(val_mious(run)) == 1 and all(np.isfinite(val_mious(run)))
    ev, per_scene = test_mvpnet.main(["--run", str(run), "--data", "synthetic:1", "--num-points", "512",
                                      "--num-views", "2", "--stride", "2.0", "--device", "cpu"])
    assert per_scene[0]["chunks"] > 0 and 0 < per_scene[0]["coverage"] <= 1
    assert ev.confusion.sum() > 0 and 0 <= ev.miou <= 1

    pn2 = train_mvpnet.main(["--data", "synthetic:1", "--val-data", "synthetic:1", "--config", cfg,
                             "--output", str(tmp_path / "pn2"), "--steps", "2", "--num-points", "512",
                             "--no-images", "--device", "cpu"])
    assert type(pn2.model).__name__ == "PN2SSG" and pn2.step == 2
    assert pn2.model.sa0.mlp.dense0.in_features == 6  # colors ⊕ xyz


def test_new_clis_without_device_raise_on_a_host_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = write_config(tmp_path)
    out = str(tmp_path / "r")
    for main, argv in ((train_2d.main, ["--config", cfg, "--output", out]),
                       (test_2d.main, ["--run", out]),
                       (train_mvpnet.main, ["--config", cfg, "--output", out]),
                       (test_mvpnet.main, ["--run", out]),
                       (precompute_2d.main, ["--run", out, "--out", str(tmp_path / "f.pkl")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--data", "synthetic:1"] + argv)
    assert not (tmp_path / "r").exists()


@pytest.mark.slow  # both packages' CLIs, JAX's compiling each step: about 2 minutes
def test_clis_write_what_the_jax_clis_write(tmp_path):
    """The port's and the JAX package's ``train_2d``, ``train_mvpnet`` (and
    ``--no-images``) at the same tiny size: the same files in the run
    directory, the same steps in ``training.txt`` and the same scalar tags;
    both ``test_2d``s reproduce their trainer's last ``val_miou``."""
    from mvkpconv_tpu.tools import test_2d as jax_test_2d
    from mvkpconv_tpu.tools import train_2d as jax_train_2d
    from mvkpconv_tpu.tools import train_mvpnet as jax_train_mvpnet
    from mvkpconv_tpu.training.config import KPConfig as JaxConfig

    jcfg = tmp_path / "jax_params.txt"
    JaxConfig(**TINY).save(jcfg)
    cfg = write_config(tmp_path)

    def listing(run):
        files = sorted(p.relative_to(run).as_posix().replace(".msgpack", ".pt") for p in run.rglob("*")
                       if p.is_file() and p.suffix not in (".log",))
        lines = (run / "training.txt").read_text().splitlines()
        tags = [json.loads(line)["tag"] for line in (run / "scalars.jsonl").read_text().splitlines()]
        return files, [ln.split()[1] for ln in lines[1:]], tags

    for name, port_main, jax_main, extra in (
        ("2d", train_2d.main, jax_train_2d.main, []),
        ("mvp", train_mvpnet.main, jax_train_mvpnet.main, ["--num-points", "512", "--num-views", "2"]),
        ("pn2", train_mvpnet.main, jax_train_mvpnet.main, ["--num-points", "512", "--no-images"]),
    ):
        common = ["--data", "synthetic:1", "--val-data", "synthetic:1", "--steps", "2"] + extra
        port_main(common + ["--config", cfg, "--output", str(tmp_path / f"port_{name}"), "--device", "cpu"])
        jax_main(common + ["--config", str(jcfg), "--output", str(tmp_path / f"jax_{name}")])
        got, want = listing(tmp_path / f"port_{name}"), listing(tmp_path / f"jax_{name}")
        assert got == want, (name, got, want)
    for pkg_test, run, device in ((test_2d.main, tmp_path / "port_2d", ["--device", "cpu"]),
                                  (jax_test_2d.main, tmp_path / "jax_2d", [])):
        ev = pkg_test(["--run", str(run), "--data", "synthetic:1"] + device)
        np.testing.assert_allclose(ev.miou, val_mious(run)[-1], atol=1e-6)
