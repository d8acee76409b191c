"""PyTorch port: configuration, numpy copies and import hygiene.

The port's KPConfig must carry every field and default of the JAX one and
read / write the same ``parameters.txt``; its numpy copies of the kernel
point dispositions and of the synthetic bench batch must equal the
originals; importing any module of the port must not import jax.
"""

import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mvkpconv_tpu.models.kernel_points import (  # noqa: E402
    kernel_point_positions as jax_kernel_points,
)
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch.data.synthetic_batch import make_batch  # noqa: E402
from mvkpconv_tpu_torch.models.kernel_points import kernel_point_positions  # noqa: E402
from mvkpconv_tpu_torch.training import config as port_config  # noqa: E402
from mvkpconv_tpu_torch.training.config import ARCHITECTURE_DEEPER, KPConfig  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

REPO = Path(__file__).resolve().parent.parent


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(KPConfig)}
    assert list(jf) == list(pf)
    for name, default in jf.items():
        if name == "compute_dtype":
            assert pf[name] == torch.float32 and jnp.dtype(default).name == "float32"
        else:
            assert pf[name] == default, name
    assert KPConfig().architecture == ARCHITECTURE_DEEPER
    cfg = KPConfig(fusion="early", num_points=(64, 16, 8), architecture=ARCHITECTURE_DEEPER[:3])
    jcfg = JaxConfig(fusion="early", num_points=(64, 16, 8), architecture=ARCHITECTURE_DEEPER[:3])
    assert cfg.num_layers == jcfg.num_layers == 2
    assert dataclasses.asdict(cfg.pyramid_spec()) == dataclasses.asdict(jcfg.pyramid_spec())
    assert cfg.base_feature_dim == jcfg.base_feature_dim
    assert cfg.replace(num_views=3).num_views == 3
    with pytest.raises(ValueError):
        KPConfig(in_features_dim=67, fusion="early").validate()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameters_txt_round_trip_across_packages(tmp_path, dtype):
    jcfg = JaxConfig(
        fusion="early", num_points=(1024, 256), conv_neighbors=(12, 12),
        class_weights=(1.0, 2.0), compute_dtype=jnp.dtype(dtype),
    )
    jcfg.save(tmp_path / "jax.txt")
    cfg = KPConfig.load(tmp_path / "jax.txt")
    assert cfg.compute_dtype == getattr(torch, dtype)
    for f in dataclasses.fields(JaxConfig):
        if f.name != "compute_dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    cfg.save(tmp_path / "port.txt")
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert JaxConfig.load(tmp_path / "port.txt") == jcfg


def test_tpu_strategies_map_to_the_port_path_with_one_warning():
    port_config._WARNED.clear()
    cfg = KPConfig(neighbor_method="approx", kpconv_tail="gform_dot", influence_cache="lazy")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert cfg.port_option("neighbor_method") == "binmin"
        assert cfg.port_option("neighbor_method") == "binmin"
        assert cfg.port_option("kpconv_tail") == "einsum"
        assert cfg.port_option("influence_cache") == "prebuilt"
        assert KPConfig().port_option("pixel_select") == "pallas"
        # the fused KPConv kernel is ported: the flag selects it, without a warning
        assert KPConfig(use_pallas_kpconv=True).port_option("use_pallas_kpconv") is True
        assert KPConfig().port_option("use_pallas_kpconv") is False
    assert len(rec) == 3
    with pytest.raises(ValueError):
        KPConfig(pixel_select="nope").port_option("pixel_select")


@pytest.mark.parametrize("radius,m", [(0.1, 15), (0.4, 15), (1.0, 7)])
def test_kernel_points_equal_the_original(radius, m):
    np.testing.assert_array_equal(
        kernel_point_positions(radius, m), jax_kernel_points(radius, m)
    )


@pytest.mark.parametrize("b", [1, 2])
def test_make_batch_equals_the_original(b):
    cfg = KPConfig(fusion="early", num_points=(512, 128), num_views=2,
                   image_height=24, image_width=32)
    jcfg = JaxConfig(fusion="early", num_points=(512, 128), num_views=2,
                     image_height=24, image_width=32)
    got = make_batch(cfg, b, np.random.RandomState(3))
    want = graft._make_batch(jcfg, b, np.random.RandomState(3))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports without jax,
    flax, optax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mvkpconv_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mvkpconv_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 55, mods\n"
        "new = {'data.spheres', 'data.synthetic', 'data.prefetch', 'data.scannet_io', "
        "'eval.voting', 'eval.evaluator', 'utils.ply', 'utils.visualize', 'training.trainer', "
        "'training.checkpoint', 'training.logger', 'training.transfer', 'tools.common', "
        "'tools.train_scannet', 'tools.test_models'}\n"
        "assert {'mvkpconv_tpu_torch.' + m for m in new} <= set(mods), mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
