"""PyTorch port: the two CLIs end to end on the CPU (``--device cpu``): train
MV-KPConv for 2 steps with the UNet trained end to end
(``tools/train_scannet``), then the voting test of its checkpoint at 0.5
votes (``tools/test_models``) with ``--html`` (the viewer beside the PLYs),
for early, middle and late fusion. For middle and late fusion the run is
also held against the JAX package: ``parameters.txt`` loads into the JAX
``KPConfig`` as it is, the checkpoint restores into a fresh model of the
port bit for bit (middle fusion's ``encoder_3d`` / ``encoder_2d`` scopes),
and that model's logits equal the JAX ``MVKPConv``'s on the same weights
(``convert.jax_variables``) within the logits contract of ROADMAP queue 3
in f32: max |Δ logit| ≤ 1e-4·max |logit| on valid points of a batch with
padded rows (f32 pixel candidates on both sides, as in
``test_torch_export.py``). Without ``--device`` on a host without a card
both CLIs raise before they load anything.
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


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads for these CPU-heavy steps: the fast tier runs six
    workers on the host's cores, and with a thread a core in every worker the
    steps slow down several-fold (on an 8-core host beside five processes
    multiplying matrices, the early-fusion case took 150 s with the default
    threads and 65 s with two; 14 and 16 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def write_config(tmp_path, **kw):
    path = tmp_path / "params.txt"
    KPConfig(**{**TINY, **kw}).save(path)
    return str(path)


def train_then_test(tmp_path, fusion):
    """``train_scannet`` for 2 steps, then ``test_models`` of the run; returns
    the Trainer and the run directory."""
    cfg = write_config(tmp_path, fusion=fusion, in_features_dim=66)
    run = tmp_path / "run"
    trainer = train_scannet.main([
        "--fusion", fusion, "--data", "synthetic:1", "--val-data", "synthetic:1",
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
    assert KPConfig.load(run / "parameters.txt").fusion == fusion

    ev, full = test_models.main(["--run", str(run), "--data", "synthetic:1", "--votes", "0.5",
                                 "--html", "--device", "cpu"])
    assert 0 <= ev.miou <= 1 and 0 <= full.miou <= 1
    assert full.confusion.sum() > ev.confusion.sum() > 0
    assert sorted(p.name for p in (run / "test_preds").iterdir()) == [
        "scene000_potentials.ply", "scene000_pred.ply", "scene000_viewer.html"]
    assert "<canvas" in (run / "test_preds" / "scene000_viewer.html").read_text()
    return trainer, run


def test_train_then_test_early_fusion_on_cpu(tmp_path):
    train_then_test(tmp_path, "early")


@pytest.mark.parametrize("fusion", ["middle", "late"])
def test_train_then_test_fusion_on_cpu_meets_jax(fusion, tmp_path):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv
    from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
    from mvkpconv_tpu.training.config import KPConfig as JaxConfig
    from mvkpconv_tpu_torch.convert import jax_variables
    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import batch_to_device, infer, make_model
    from mvkpconv_tpu_torch.training.jax_checkpoint import restore_run

    trainer, run = train_then_test(tmp_path, fusion)
    # f32 pixel candidates on both sides: with bf16 ones the two packages'
    # pixel selections may pick another of two pixels whose d² tie in bf16
    f32_pixels = dict(pixel_patch_dtype="float32")
    cfg = KPConfig.load(run / "parameters.txt").replace(**f32_pixels)
    model = make_model(cfg, "cpu", seed=7)
    assert restore_run(model, run / "checkpoints")[0] == 2
    trained = trainer.model.state_dict()
    assert model.state_dict().keys() == trained.keys()
    assert all(torch.equal(v, trained[k]) for k, v in model.state_dict().items())
    scopes = {k.split(".")[0] for k in trained}
    assert {"encoder_3d", "encoder_2d"} <= scopes if fusion == "middle" else "encoder" in scopes

    jcfg = JaxConfig.load(run / "parameters.txt").replace(**f32_pixels)
    assert (jcfg.fusion, jcfg.architecture, jcfg.in_features_dim) == (fusion, cfg.architecture, 66)
    batch = make_batch(cfg, 2, np.random.RandomState(0))
    batch["mask"][-1, -40:] = False
    batch["points"] = np.where(batch["mask"][..., None], batch["points"], np.float32(1e6))
    got = infer(model, batch_to_device(batch, "cpu")).numpy()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxMVKPConv(jcfg)

    @jax.jit
    def logits(variables, jb):
        pyr = jax_build_pyramid(jb["points"], jb["mask"], jcfg.pyramid_spec())
        return jmodel.apply(variables, jb, pyr, train=False)

    want = np.asarray(logits(jax_variables(model), jb))
    valid = batch["mask"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want)[valid].max() <= 1e-4 * np.abs(want[valid]).max()


def test_clis_without_device_raise_on_a_host_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = write_config(tmp_path, fusion="none", in_features_dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_scannet.main(["--data", "synthetic:1", "--config", cfg, "--output", str(tmp_path / "r"),
                            "--steps", "1"])
    assert not (tmp_path / "r").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_models.main(["--run", str(tmp_path / "r")])
