"""PyTorch port: deformable-kernel inspection (``mvkpconv_tpu_torch/eval/
deform_inspect.py``, ``tools/inspect_deform.py``) against the JAX package's
(``tests/test_deform_inspect.py``).

One sphere batch of a synthetic scene and one set of random weights go to
both packages' ``inspect_deformable`` at the JAX test's configuration (two
deformable blocks, a strided one first): the statistics JSON within 1e-5
(names, levels and extents equal), and each layer's PLY with the same rows:
kind, query and kernel-point ids and colours equal, points and fitting
distances within 1e-5. The negative case: collecting before any forward
raises. The CLI writes its files on ``--device cpu``.
"""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mvkpconv_tpu.data import SphereDataset as JaxSphereDataset  # noqa: E402
from mvkpconv_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mvkpconv_tpu.data.spheres import device_batch  # noqa: E402
from mvkpconv_tpu.eval.deform_inspect import inspect_deformable as jax_inspect  # noqa: E402
from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.eval.deform_inspect import (  # noqa: E402
    collect_deform_layers,
    inspect_deformable,
)
from mvkpconv_tpu_torch.infer import batch_to_device, model_pyramid  # noqa: E402
from mvkpconv_tpu_torch.models.kpfcnn import KPFCNN  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.utils.ply import read_ply  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402

ABS = 1e-5
# tests/test_deform_inspect.py's configuration
KW = dict(
    architecture=("simple", "resnetb", "resnetb_deformable_strided", "resnetb_deformable",
                  "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
    first_features_dim=16, first_subsampling_dl=0.1, in_radius=1.0,
    in_features_dim=2, num_classes=8, batch_num=2,
)


def setup():
    jcfg = JaxConfig(**KW)
    scenes = [jax_synthetic.make_scene(seed=0, num_points=8000)]
    batch = device_batch(JaxSphereDataset(scenes, jcfg, training=False, seed=0).sample_batch())
    jmodel = JaxKPFCNN(jcfg)

    def init():
        pyr = jax_build_pyramid(jnp.asarray(batch["points"]), jnp.asarray(batch["mask"]),
                                jcfg.pyramid_spec())
        return jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["features"]), pyr)

    variables = random_variables(jax.eval_shape(init))
    model = load_jax_variables(KPFCNN(KPConfig(**KW)), jax.tree.map(np.asarray, variables))
    return jcfg, jmodel, variables, model, batch


def test_inspect_deformable_matches_jax(tmp_path):
    jcfg, jmodel, variables, model, batch = setup()
    want = jax_inspect(jmodel, variables, batch, jcfg, tmp_path / "jax")
    got = inspect_deformable(model, batch, KPConfig(**KW), tmp_path / "port")
    assert json.loads((tmp_path / "port" / "deform_stats.json").read_text())["layers"] == got["layers"]
    assert len(got["layers"]) == len(want["layers"]) == 2
    for g, w in zip(got["layers"], want["layers"]):
        assert (g["name"], g["level"]) == (w["name"], w["level"])
        for key in ("extent", "mean_kp_radius", "max_kp_radius", "fit_fraction"):
            assert abs(g[key] - w[key]) <= ABS, (g["name"], key, g[key], w[key])
    assert [s["name"] for s in got["layers"]] == [
        "encoder/block_2[resnetb_deformable_strided]", "encoder/block_3[resnetb_deformable]"]
    for gp, wp in zip(got["plys"], want["plys"]):
        assert gp.rsplit("/", 1)[1] == wp.rsplit("/", 1)[1]
        g, w = read_ply(gp), read_ply(wp)
        assert sorted(g) == sorted(w) and len(g["x"]) == len(w["x"])
        for f in ("red", "green", "blue", "kind", "query_id", "kp_id"):
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
        for f in ("x", "y", "z", "min_d2"):
            np.testing.assert_allclose(g[f], w[f], rtol=0, atol=ABS, err_msg=f)
        assert (g["kind"] == 1).sum() % KPConfig(**KW).num_kernel_points == 0
    assert sorted(p.name for p in (tmp_path / "port").glob("*.html")) == [
        "deform_layer0_L1.html", "deform_layer1_L1.html"]


def test_collect_requires_a_forward():
    _jcfg, _jmodel, _variables, model, batch = setup()
    cfg = KPConfig(**KW)
    pyr = model_pyramid(model, batch_to_device(batch, "cpu"))
    with pytest.raises(ValueError, match="forward"):
        collect_deform_layers(model, cfg, pyr)


def test_inspect_deform_cli(tmp_path):
    from mvkpconv_tpu_torch.tools import inspect_deform

    cfg = KPConfig(**KW)
    cfg.save(tmp_path / "parameters.txt")
    inspect_deform.main(["--data", "synthetic:1", "--config", str(tmp_path / "parameters.txt"),
                         "--output", str(tmp_path / "deform"), "--device", "cpu"])
    out = tmp_path / "deform"
    stats = json.loads((out / "deform_stats.json").read_text())
    assert [s["level"] for s in stats["layers"]] == [1, 1]
    assert len(list(out.glob("deform_layer*.ply"))) == 2
