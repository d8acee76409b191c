"""PyTorch port: the two CLIs end to end on the CPU (``--device cpu``): train
MV-KPConv early fusion for 2 steps with the UNet trained end to end
(``tools/train_scannet``), then the voting test of its checkpoint at 0.5
votes (``tools/test_models``) with ``--html`` (the viewer beside the PLYs);
without ``--device`` on a host without a card both raise before they load
anything.
"""

import json

import numpy as np
import pytest
import torch

from mvkpconv_tpu_torch.tools import test_models, train_scannet
from mvkpconv_tpu_torch.training.config import KPConfig

# tests/test_tools.py's TINY, the JAX CLI test size
TINY = dict(
    architecture=("simple", "resnetb_strided", "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(8, 8), pool_neighbors=(8,),
    first_features_dim=16, first_subsampling_dl=0.1, in_radius=1.0,
    batch_num=2, epoch_steps=2, validation_size=2,
    num_views=2, image_height=24, image_width=32,
)


def write_config(tmp_path, **kw):
    path = tmp_path / "params.txt"
    KPConfig(**{**TINY, **kw}).save(path)
    return str(path)


def test_train_then_test_early_fusion_on_cpu(tmp_path):
    cfg = write_config(tmp_path, fusion="early", in_features_dim=66)
    run = tmp_path / "run"
    trainer = train_scannet.main([
        "--fusion", "early", "--data", "synthetic:1", "--val-data", "synthetic:1",
        "--config", cfg, "--output", str(run), "--steps", "2", "--device", "cpu",
    ])
    assert trainer.step == 2
    assert not trainer.model.freeze_2d  # no --path-2d: the UNet trains
    lines = (run / "training.txt").read_text().splitlines()
    assert [ln.split()[1] for ln in lines[1:]] == ["1", "2"]
    assert all(np.isfinite(float(ln.split()[2])) for ln in lines[1:])
    vals = [json.loads(ln) for ln in (run / "scalars.jsonl").read_text().splitlines()]
    assert [v["tag"] for v in vals] == ["val_miou", "val_miou"]  # step 2, and the final one
    assert (run / "checkpoints" / "last_checkpoint").read_text() == "ckpt_00000002.pt"
    assert (run / "val_preds" / "scene000_pred.ply").exists()
    assert KPConfig.load(run / "parameters.txt").fusion == "early"

    ev, full = test_models.main(["--run", str(run), "--data", "synthetic:1", "--votes", "0.5",
                                 "--html", "--device", "cpu"])
    assert 0 <= ev.miou <= 1 and 0 <= full.miou <= 1
    assert full.confusion.sum() > ev.confusion.sum() > 0
    assert sorted(p.name for p in (run / "test_preds").iterdir()) == [
        "scene000_potentials.ply", "scene000_pred.ply", "scene000_viewer.html"]
    assert "<canvas" in (run / "test_preds" / "scene000_viewer.html").read_text()


def test_clis_without_device_raise_on_a_host_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = write_config(tmp_path, fusion="none", in_features_dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_scannet.main(["--data", "synthetic:1", "--config", cfg, "--output", str(tmp_path / "r"),
                            "--steps", "1"])
    assert not (tmp_path / "r").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_models.main(["--run", str(tmp_path / "r")])
