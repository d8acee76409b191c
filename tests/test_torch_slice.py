"""PyTorch port: the MV-KPConv early-fusion inference slice end to end,
held against the JAX package on the same numpy batch and the same weights
(random, from a numpy seed, bridged with ``convert.py``).

  * the whole slice from the raw batch (pyramid, projective pixel
    association, UNet, lift, trunk, head);
  * the trunk alone, given the JAX-built pyramid and the JAX pixel
    association (``knn_indices`` / ``image_xyz`` batch keys), so trunk
    faults are told apart from selection differences.

The pixel candidates stay f32 (``pixel_patch_dtype='float32'``): with bf16
candidates the JAX package's CPU path rounds the points to bf16 too, which
its TPU kernel does not, so it is no reference there (the port's bf16
selection is held against the TPU kernel in test_torch_lift.py).
Logits are compared on mask-valid points only (padded rows select padded
rows in either package and never reach valid ones). Tolerances:
f32 max |Δ| ≤ 1e-4 · max |logit|; bf16 max |Δ| ≤ 2e-2 · max |logit|.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.ops.unproject import (  # noqa: E402
    points_to_pixel_knn_projective as jax_pixel_knn,
    unproject_depth as jax_unproject,
)
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.infer import batch_to_device, infer, make_model, resolve_device  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.ops.pyramid import Pyramid  # noqa: E402
from mvkpconv_tpu_torch.train import make_trainer  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

REL = {"float32": 1e-4, "bfloat16": 2e-2}

CONFIGS = {
    "small": dict(  # the dryrun_multichip configuration
        fusion="early", in_features_dim=66,
        architecture=("simple", "resnetb", "resnetb_strided", "resnetb",
                      "nearest_upsample", "unary"),
        num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
        first_features_dim=32, num_views=2, image_height=24, image_width=32,
        pixel_patch_dtype="float32",
    ),
    "deeper": dict(  # ARCHITECTURE_DEEPER, 5 levels
        fusion="early", in_features_dim=66, num_points=(1024, 256, 64, 32, 16),
        conv_neighbors=(16,) * 5, pool_neighbors=(16,) * 4,
        first_features_dim=32, num_views=3, image_height=24, image_width=32,
        pixel_patch_dtype="float32",
    ),
}


def random_variables(shapes, seed=0):
    """Weights for a flax variable tree: LeCun-scaled normal kernels, random
    biases and BN statistics."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def setup(name):
    """(JAX config, numpy batch with padded rows, JAX pyramid, variables)."""
    jcfg = JaxConfig(**CONFIGS[name])
    batch = graft._make_batch(jcfg, 2, np.random.RandomState(0))
    batch["mask"][-1, -24:] = False
    batch["points"] = np.where(batch["mask"][..., None], batch["points"], np.float32(1e6))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pyr = jax.jit(functools.partial(jax_build_pyramid, spec=jcfg.pyramid_spec()))(
        jb["points"], jb["mask"]
    )
    model = JaxMVKPConv(jcfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jb, pyr, train=False)
    )
    return jcfg, batch, pyr, random_variables(shapes)


def jax_logits(jcfg, dtype, variables, batch, pyr):
    model = JaxMVKPConv(jcfg.replace(compute_dtype=jnp.dtype(dtype)))
    fn = jax.jit(lambda v, b, p: model.apply(v, b, p, train=False))
    return np.asarray(fn(variables, {k: jnp.asarray(x) for k, x in batch.items()}, pyr))


def port_model(name, dtype, variables):
    cfg = KPConfig(**CONFIGS[name], compute_dtype=dtype)
    model = MVKPConv(cfg)
    load_jax_variables(model, variables)
    return model.eval()


def assert_logits_close(got, want, mask, rel):
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)[mask].max()
    scale = np.abs(want[mask]).max()
    assert err <= rel * scale, (err, scale, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["small", "deeper"])
def test_slice_from_raw_batch_matches_jax(name, dtype):
    jcfg, batch, pyr, variables = setup(name)
    want = jax_logits(jcfg, dtype, variables, batch, pyr)
    model = port_model(name, dtype, variables)
    got = infer(model, batch_to_device(batch, "cpu"))
    assert got.dtype == torch.float32
    assert_logits_close(got, want, batch["mask"], REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_given_jax_pyramid_and_association(dtype):
    jcfg, batch, pyr, variables = setup("deeper")
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    image_xyz, _ = jax_unproject(b["depth"], b["intrinsics"], b["poses"])
    knn = jax_pixel_knn(
        pyr.points[0], image_xyz, b["intrinsics"], b["poses"], jcfg.pixel_knn,
        window=jcfg.pixel_window, method="minext",
    )
    batch = dict(batch, image_xyz=np.array(image_xyz), knn_indices=np.array(knn))
    want = jax_logits(jcfg, dtype, variables, batch, pyr)
    tpyr = Pyramid(*(tuple(torch.from_numpy(np.array(t)) for t in field) for field in pyr))
    model = port_model("deeper", dtype, variables)
    with torch.no_grad():
        got = model(batch_to_device(batch, "cpu"), tpyr)
    assert_logits_close(got, want, batch["mask"], REL[dtype])


@pytest.mark.parametrize("fusion", ["early", "middle", "late"])
def test_entry_points_default_to_the_card_and_raise_without_one(fusion):
    """``make_model(cfg)`` and ``make_trainer(cfg)`` build on ``cuda:0``; on a
    host without a card they raise and never carry on on the CPU by
    themselves. ``device='cpu'`` builds there (the kernels' plain versions)."""
    cfg = KPConfig(**dict(CONFIGS["small"], fusion=fusion))
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
    else:
        for build in (make_model, make_trainer):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build(cfg)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build(cfg, None, seed=1)
    model = make_model(cfg, device="cpu", seed=0)
    assert not model.training
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    trainer = make_trainer(cfg, device="cpu", seed=0)
    assert trainer.model.training and not trainer.model.net_2d.training
    assert {p.device.type for p in trainer.model.parameters()} == {"cpu"}
    _jcfg, batch, _pyr, _variables = setup("small")
    logits = infer(model, batch_to_device(batch, "cpu"))
    assert logits.shape == (2, 256, cfg.num_classes) and torch.isfinite(logits).all()
