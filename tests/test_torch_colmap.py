"""PyTorch port: the custom-dataset inference slice as a whole
(``tools/test_colmap.py``) against the JAX package's tool, on a fabricated
COLMAP workspace (``tests/test_colmap.py``'s synthetic room: 8,000 laser
points, 3 views whose 48×64 depth maps are resized to the run's 24×32).

A JAX run directory (the JAX CLI test's architecture ``simple,
resnetb_strided, nearest_upsample, unary``, N0 = 256, width 16; MV-KPConv
early fusion with 2 views, or the 3D-only KPFCNN) holds a ``TrainState`` of
seeded random weights saved as ``.msgpack`` by the JAX ``Checkpointer``.
The JAX ``test_colmap`` and the port's ``test_colmap --device cpu`` run on
it at 0.05 votes: the per-point probabilities the voting accumulates agree
within 1e-4 of their largest, the predicted labels are equal except where
the two best classes lie within that bound of each other, and so are the
prediction PLYs' labels (same points, in the ScanNet palette). Both
packages run on their numpy host ops here (the native ones are held against
each other in ``tests/test_torch_native.py``).

The KPFCNN case runs in the fast tier (~10 s); MV-KPConv, whose JAX tool
jits the UNet's init and forward (~35 s on the CPU), under ``-m slow``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
import mvkpconv_tpu.eval as jax_eval  # noqa: E402
from mvkpconv_tpu.data import native as jax_native  # noqa: E402
from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN  # noqa: E402
from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.tools import test_colmap as jax_test_colmap  # noqa: E402
from mvkpconv_tpu.training.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import create_train_state  # noqa: E402
from mvkpconv_tpu_torch.data import native  # noqa: E402
from mvkpconv_tpu_torch.tools import test_colmap  # noqa: E402
from mvkpconv_tpu_torch.utils.ply import read_ply  # noqa: E402
from test_torch_io import make_workspace  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402

REL = 1e-4
TINY = dict(
    architecture=("simple", "resnetb_strided", "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(8, 8), pool_neighbors=(8,),
    first_features_dim=16, first_subsampling_dl=0.1, in_radius=1.0,
    batch_num=2, num_views=2, image_height=24, image_width=32, pixel_patch_dtype="float32",
)


def jax_run_dir(root, fusion):
    """A JAX run directory: ``parameters.txt`` and a step-5 ``TrainState``
    of seeded random weights in ``checkpoints/ckpt_00000005.msgpack``."""
    jcfg = JaxConfig(**TINY, fusion=fusion, in_features_dim=2 if fusion == "none" else 66)
    run = root / f"run_{fusion}"
    run.mkdir(parents=True)
    jcfg.save(run / "parameters.txt")
    shapes_of = jcfg.replace(fusion="early", in_features_dim=66)  # the batch's shapes alone matter
    batch = {k: jnp.asarray(v) for k, v in graft._make_batch(shapes_of, jcfg.batch_num,
                                                             np.random.RandomState(0)).items()}
    batch["features"] = batch["features"][..., : jcfg.in_features_dim]
    model = JaxKPFCNN(jcfg) if fusion == "none" else JaxMVKPConv(jcfg)

    def init():
        pyr = jax_build_pyramid(batch["points"], batch["mask"], jcfg.pyramid_spec())
        return model.init(jax.random.PRNGKey(0), batch["features"] if fusion == "none" else batch, pyr)

    variables = random_variables(jax.eval_shape(init), seed=3)
    state = create_train_state(variables, make_optimizer(jcfg))._replace(step=jnp.asarray(5, jnp.int32))
    JaxCheckpointer(run / "checkpoints").save(state, 5)
    return run, jcfg


def run_both(tmp_path, monkeypatch, fusion):
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)
    sparse, depths, laser, _, _ = make_workspace(tmp_path, num_points=8000)
    run, jcfg = jax_run_dir(tmp_path, fusion)
    testers = []

    class Recording(jax_eval.VotingTester):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            testers.append(self)

    monkeypatch.setattr(jax_eval, "VotingTester", Recording)
    argv = ["--run", str(run), "--sparse", str(sparse), "--depths", str(depths), "--laser", str(laser),
            "--votes", "0.05"]
    jax_test_colmap.main(argv + ["--output-ply", str(tmp_path / "jax.ply")])
    tester = test_colmap.main(argv + ["--output-ply", str(tmp_path / "port.ply"), "--device", "cpu"])
    return tester, testers[0], jcfg


@pytest.mark.parametrize("fusion", [
    "none", pytest.param("early", marks=pytest.mark.slow),  # the JAX tool jits the UNet: ~35 s
])
def test_test_colmap_on_a_jax_run_matches_jax(tmp_path, monkeypatch, fusion):
    tester, jtester, jcfg = run_both(tmp_path, monkeypatch, fusion)
    got, want = tester.probs[0], jtester.probs[0]
    assert got.shape == want.shape == (len(tester.ds.scenes[0]["points"]), jcfg.num_classes)
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= REL * scale, (np.abs(got - want).max(), scale)
    top2 = np.sort(want, -1)[:, -2:]
    near_tie = top2[:, 1] - top2[:, 0] <= REL * scale
    differ = got.argmax(-1) != want.argmax(-1)
    assert not (differ & ~near_tie).any(), (int(differ.sum()), int(near_tie.sum()))
    ply, jply = read_ply(tmp_path / "port.ply"), read_ply(tmp_path / "jax.ply")
    assert len(ply["pred"]) == len(got) and 0 <= ply["pred"].min() and ply["pred"].max() < jcfg.num_classes
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(ply[k], jply[k])
    np.testing.assert_array_equal(ply["pred"][~near_tie], jply["pred"][~near_tie])
    # the sweep ran (the scan's labels are all -1: nothing is scored, no error)
    assert tester.ds.min_potential() >= 0.05 and (tester.ds.scenes[0]["labels"] == -1).all()


def test_test_colmap_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sparse, depths, laser, _, _ = make_workspace(tmp_path, num_points=2000, views=1)
    run = tmp_path / "run"
    run.mkdir()
    JaxConfig(**TINY, fusion="none", in_features_dim=2).save(run / "parameters.txt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_colmap.main(["--run", str(run), "--sparse", str(sparse), "--depths", str(depths),
                          "--laser", str(laser)])
