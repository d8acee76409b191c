"""PyTorch port: the 3D-only KPFCNN segmentation baseline and the KPCNN
classifier against the JAX package, on the same numpy inputs and the same
weights (flax variables bridged by ``convert.py``), and the pieces around
them: the entry points' ``fusion='none'`` model, ``block_decider``'s block
kinds, the bridge's completeness on deformable and KPCNN leaves, and
``PyramidSpec.for_architecture``.

Tolerances: logits f32 max |Δ| ≤ 1e-4 · max |logit|, bf16 ≤ 2e-2 · max
|logit|, on mask-valid points; the train step's loss, gradients, accuracy
and state within the train-step contract (ROADMAP queue 3: rtol 2e-4, atol
2e-5; accuracy within 5e-3); eval probabilities within 1e-4 absolute.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.models import KPCNN as JaxKPCNN  # noqa: E402
from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN  # noqa: E402
from mvkpconv_tpu.ops import masked_points  # noqa: E402
from mvkpconv_tpu.ops.pyramid import PyramidSpec as JaxPyramidSpec  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import (  # noqa: E402
    create_train_state,
    make_apply_fn,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.data.synthetic_batch import make_batch  # noqa: E402
from mvkpconv_tpu_torch.infer import (  # noqa: E402
    baseline_config,
    batch_to_device,
    bench_config,
    deform_config,
    infer,
    make_model,
)
from mvkpconv_tpu_torch.models import blocks as B  # noqa: E402
from mvkpconv_tpu_torch.models.kpfcnn import KPCNN, KPFCNN  # noqa: E402
from mvkpconv_tpu_torch.ops.pyramid import PyramidSpec  # noqa: E402
from mvkpconv_tpu_torch.train import make_trainer  # noqa: E402
from mvkpconv_tpu_torch.training.config import ARCHITECTURE_DEEPER, KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.steps import forward_backward, make_eval_step  # noqa: E402
from test_torch_deformable import CONFIGS as DEFORM_CONFIGS  # noqa: E402
from test_torch_deformable import jitter_witness, padded_batch, recording, torch_pyramid  # noqa: E402
from test_torch_deformable import setup as deform_setup  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

REL = {"float32": 1e-4, "bfloat16": 2e-2}
TOL = dict(rtol=2e-4, atol=2e-5)
ACC_ABS = 5e-3

BASELINE = dict(  # the dryrun_multichip trunk, 3D only
    fusion="none", in_features_dim=2,
    architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
    first_features_dim=32,
)
FUSED = dict(use_pallas_kpconv=True, influence_cache="none")
# chip_smoke.py's train_parity_baseline trunk
THREE_LEVELS = ("simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided", "resnetb",
                "nearest_upsample", "unary", "nearest_upsample", "unary")


@functools.lru_cache(maxsize=None)
def setup():
    """(JAX config, padded numpy batch, JAX pyramid, variables)."""
    jcfg = JaxConfig(**BASELINE)
    batch = padded_batch(KPConfig(**BASELINE))
    jpyr = jax.jit(functools.partial(jax_build_pyramid, spec=jcfg.pyramid_spec()))(
        jnp.asarray(batch["points"]), jnp.asarray(batch["mask"]))
    shapes = jax.eval_shape(lambda: JaxKPFCNN(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["features"]), jpyr))
    return jcfg, batch, jpyr, random_variables(shapes)


def assert_logits_close(got, want, mask, rel):
    got = got.detach().float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want)[mask].max(), np.abs(want[mask]).max()
    assert err <= rel * scale, (err, scale, rel)


@pytest.mark.parametrize("variant", ["float32", "bfloat16", "float32-fused"])
def test_kpfcnn_logits_match_jax(variant, monkeypatch):
    """Eval-mode logits on the JAX pyramid; ``-fused`` is the fused KPConv
    path (``use_pallas_kpconv=True, influence_cache='none'``: every conv
    block through the fused kernel's plain version here, the JAX model
    through its einsum path off the TPU)."""
    dtype, fused = variant.split("-")[0], variant.endswith("fused")
    flags = dict(FUSED if fused else {}, compute_dtype=dtype)
    jcfg0, batch, jpyr, variables = setup()
    jcfg = jcfg0.replace(**FUSED) if fused else jcfg0
    jcfg = jcfg.replace(compute_dtype=jnp.dtype(dtype))
    feats = jnp.asarray(batch["features"])
    want = np.asarray(jax.jit(lambda v, f, p: JaxKPFCNN(jcfg).apply(v, f, p))(variables, feats, jpyr))
    model = load_jax_variables(KPFCNN(KPConfig(**BASELINE, **flags)), variables).eval()
    calls = []
    fused_fn = B.kpconv_fused
    monkeypatch.setattr(B, "kpconv_fused", lambda *a: calls.append(1) or fused_fn(*a))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["features"]), torch_pyramid(jpyr))
    assert len(calls) == (4 if fused else 0)  # the four conv blocks
    assert_logits_close(got, want, batch["mask"], REL[dtype])


def test_kpfcnn_train_and_eval_step_match_jax():
    """One train step of the baseline (``make_trainer`` with ``fusion='none'``
    builds a KPFCNN; ``train_steps`` gives it the batch's features), each
    package on its own pyramid of the padded batch: the loss, every
    gradient, the accuracy and the state after the step; then the eval
    step's probabilities on valid points."""
    jcfg0, batch, _jpyr, variables = setup()
    jcfg = jcfg0.replace(gather_transpose="scatter")
    model = JaxKPFCNN(jcfg)
    apply_fn = make_apply_fn(model, jcfg, "kpfcnn")
    jb = {k: jnp.asarray(batch[k]) for k in ("points", "mask", "features", "labels")}

    tx = recording(jax_make_optimizer(jcfg))
    state, jm = jax_make_train_step(apply_fn, tx, jcfg, donate=False)(create_train_state(variables, tx), jb)
    jloss, jgrads = jm["loss"], state.opt_state[1]  # the loss and gradients before the update
    jprobs = np.asarray(jax_make_eval_step(apply_fn, jcfg)(state, jb))

    cfg = KPConfig(**BASELINE, gather_transpose="scatter")
    tb = batch_to_device(batch, "cpu")
    port = load_jax_variables(KPFCNN(cfg), variables)
    loss, _ = forward_backward(port, cfg, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = dict(load_jax_variables(KPFCNN(cfg), {"params": jax.tree.map(np.asarray, jgrads),
                                                 "batch_stats": variables["batch_stats"]}).named_parameters())
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].detach().numpy(), err_msg=f"grad {n}", **TOL)

    trainer = make_trainer(cfg, "cpu", seed=0)
    assert isinstance(trainer.model, KPFCNN) and trainer.model.training
    load_jax_variables(trainer.model, variables)
    m = trainer.step(tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert abs(float(m["accuracy"]) - float(jm["accuracy"])) <= ACC_ABS
    after = load_jax_variables(KPFCNN(cfg), {"params": jax.tree.map(np.asarray, state.params),
                                             "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    got_state, want_state = trainer.model.state_dict(), after.state_dict()
    assert sorted(got_state) == sorted(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(got_state[k].numpy(), v.numpy(), err_msg=f"state {k}", **TOL)
    probs = make_eval_step(trainer.model, cfg)(tb)
    assert not trainer.model.training
    valid = batch["mask"]
    np.testing.assert_allclose(probs.numpy()[valid], jprobs[valid], rtol=0, atol=1e-4)
    # infer() on a KPFCNN takes the batch's features, as the eval step does
    np.testing.assert_allclose(torch.softmax(infer(trainer.model, tb), -1).numpy(), probs.numpy(),
                               rtol=0, atol=1e-6)


KPCNN_CFG = dict(
    architecture=("simple", "resnetb_strided", "resnetb", "global_average"),
    num_points=(256, 64), conv_neighbors=(8, 8), pool_neighbors=(8,),
    first_features_dim=16, first_subsampling_dl=0.1, in_features_dim=1, num_classes=10,
)


@functools.lru_cache(maxsize=None)
def kpcnn_inputs():
    """The padded batch of tests/test_misc_models.py's KPCNN test."""
    rng = np.random.RandomState(0)
    pts = rng.rand(2, 256, 3).astype(np.float32)
    mask = np.ones((2, 256), bool)
    mask[:, -20:] = False
    pts = np.asarray(masked_points(jnp.asarray(pts), jnp.asarray(mask)))
    jcfg = JaxConfig(**KPCNN_CFG)
    jpyr = jax.jit(functools.partial(jax_build_pyramid, spec=jcfg.pyramid_spec()))(
        jnp.asarray(pts), jnp.asarray(mask))
    return jcfg, jpyr, np.ones((2, 256, 1), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kpcnn_logits_match_jax(dtype):
    """KPCNN class logits (2, 10) on a padded batch: the masked mean over
    the coarsest level's valid points, head_mlp, head_softmax."""
    jcfg, jpyr, feats = kpcnn_inputs()
    jcfg = jcfg.replace(compute_dtype=jnp.dtype(dtype))
    model = JaxKPCNN(jcfg)
    variables = random_variables(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(feats), jpyr)))
    want = np.asarray(jax.jit(lambda v, f, p: model.apply(v, f, p))(variables, jnp.asarray(feats), jpyr))
    port = load_jax_variables(KPCNN(KPConfig(**KPCNN_CFG, compute_dtype=dtype)), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch_pyramid(jpyr))
    assert got.shape == (2, 10)
    assert_logits_close(got, want, np.ones(2, bool), REL[dtype])


def test_global_average_is_the_masked_mean():
    _jcfg, jpyr, _ = kpcnn_inputs()
    pyr = torch_pyramid(jpyr)
    x = torch.randn(2, pyr.points[-1].shape[1], 5)
    m = pyr.masks[-1]
    want = torch.stack([x[i][m[i]].mean(0) for i in range(2)])
    torch.testing.assert_close(B.GlobalAverageBlock()(x, pyr), want)


def _drop(tree, path):
    """A copy of a nested dict without the leaf at ``path``."""
    head, *rest = path
    return {k: (_drop(v, rest) if rest and k == head else v) for k, v in tree.items()
            if rest or k != head}


def test_convert_sets_every_deformable_and_kpcnn_leaf():
    """A deformable (modulated) KPFCNN and a KPCNN load every flax leaf,
    ``offset_bias`` and the nested ``offset_conv`` included; a missing one
    raises, the ``intermediates`` collection is dropped and any other
    collection still raises."""
    jcfg, batch, jpyr, _tpyr, variables = deform_setup("modulated")
    jmodel = JaxKPFCNN(jcfg)
    _, sown = jax.eval_shape(lambda v, f, p: jmodel.apply(v, f, p, train=True, mutable=["batch_stats", "intermediates"]),
                             variables, jnp.asarray(batch["features"]), jpyr)
    intermediates = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), sown["intermediates"])
    assert intermediates
    port = KPFCNN(KPConfig(**DEFORM_CONFIGS["modulated"]))
    load_jax_variables(port, {**variables, "intermediates": intermediates})
    layer = port.encoder.block_1.KPConv
    assert layer.deformable and layer.offset_bias.shape == (15 * 4,)
    flax_layer = variables["params"]["encoder"]["block_1"]["KPConv"]
    np.testing.assert_array_equal(layer.offset_bias.detach().numpy(), flax_layer["offset_bias"])
    np.testing.assert_array_equal(layer.offset_conv.weights.detach().numpy(), flax_layer["offset_conv"]["weights"])
    for path in (("encoder", "block_1", "KPConv", "offset_bias"),
                 ("encoder", "block_2", "KPConv", "offset_conv", "weights")):
        with pytest.raises(KeyError, match=path[-1]):
            load_jax_variables(port, {**variables, "params": _drop(variables["params"], path)})
    with pytest.raises(ValueError, match="collections"):
        load_jax_variables(port, {**variables, "cache": {}})

    kcfg, kpyr, feats = kpcnn_inputs()
    kvars = random_variables(jax.eval_shape(lambda: JaxKPCNN(kcfg).init(jax.random.PRNGKey(0), jnp.asarray(feats), kpyr)))
    kpcnn = load_jax_variables(KPCNN(KPConfig(**KPCNN_CFG)), kvars)
    np.testing.assert_array_equal(kpcnn.head_softmax.bias.detach().numpy(), kvars["params"]["head_softmax"]["bias"])
    for path in (("head_softmax", "bias"), ("head_mlp", "mlp", "kernel")):
        with pytest.raises(KeyError, match=path[-1]):
            load_jax_variables(KPCNN(KPConfig(**KPCNN_CFG)), {**kvars, "params": _drop(kvars["params"], path)})


ARCHITECTURES = {
    "deeper": ARCHITECTURE_DEEPER,
    "deform": deform_config().architecture,
    "kpcnn": KPCNN_CFG["architecture"],
    "deform_small": DEFORM_CONFIGS["deform"]["architecture"],
}


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_pyramid_spec_for_architecture_matches_jax(name):
    arch = ARCHITECTURES[name]
    for kw in ({}, dict(conv_neighbors=(20,) * 5, pool_neighbors=(24,) * 4, subsample_ratio=3.0)):
        want = JaxPyramidSpec.for_architecture(arch, 5000, **kw)
        got = PyramidSpec.for_architecture(arch, 5000, **kw)
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
            f: getattr(want, f) for f in want.__dataclass_fields__}


def test_entry_points_build_every_model_kind():
    """``block_decider`` builds the four deformable kinds and
    ``global_average``; ``make_model`` builds a KPFCNN for
    ``fusion='none'``; the two configurations beside the bench one."""
    cfg = KPConfig(**BASELINE)
    for name in ("simple_deformable", "simple_deformable_strided",
                 "resnetb_deformable", "resnetb_deformable_strided"):
        block = B.block_decider(name, 0.1, 16, 32, 0, cfg)
        assert block.KPConv.deformable and not block.KPConv.offset_conv.deformable
        assert block.KPConv.offset_conv.weights.shape[-1] == 15 * 3
    modulated = B.block_decider("resnetb_deformable", 0.1, 16, 32, 0, cfg.replace(modulated=True))
    assert modulated.KPConv.offset_bias.shape == (15 * 4,)
    assert isinstance(B.block_decider("global_average", 0.1, 16, 32, 0, cfg), B.GlobalAverageBlock)
    assert isinstance(make_model(cfg, "cpu"), KPFCNN)
    with pytest.raises(ValueError, match="global_average"):
        KPCNN(cfg)

    base = baseline_config()
    assert base.fusion == "none" and base.base_feature_dim == 2
    assert base.replace(fusion="early", in_features_dim=66) == bench_config()
    deform = deform_config()
    assert deform.replace(architecture=ARCHITECTURE_DEEPER) == bench_config()
    assert [b for b in deform.architecture if "deform" in b] == [
        "resnetb_deformable", "resnetb_deformable", "resnetb_deformable_strided",
        "resnetb_deformable", "resnetb_deformable"]
    spec = deform.pyramid_spec()
    assert spec.deform_conv_levels == (False, False, False, True, True)
    assert spec.deform_pool_levels == (False, False, False, True)
    assert spec.radius(3) == pytest.approx(0.04 * 8 * 6.0) and spec.conv_k(3) == 30
    small = base.replace(num_points=(256, 64, 32, 16, 8))
    batch = make_batch(small, 2, np.random.RandomState(0))
    assert batch["features"].shape == (2, 256, 2)


@pytest.mark.slow
def test_deeper_trunk_step_follows_rounding_three_levels_do_not():
    """Why ``chip_smoke.py`` holds the KPFCNN's train steps at 3 levels:
    at ARCHITECTURE_DEEPER (N0=1024, 16 points a sphere at level 4) the third
    step, from one state, moves a tensor by more than the card's allowance
    when a 1e-7 relative weight jitter flips one of its ~700k leaky-ReLU
    inputs, which about half of the draws do; at 3 levels (64 points a sphere
    at the deepest) no draw moves any tensor by a tenth of it."""
    deeper = KPConfig(fusion="none", in_features_dim=2, architecture=ARCHITECTURE_DEEPER,
                      num_points=(1024, 256, 64, 32, 16), conv_neighbors=(16,) * 5,
                      pool_neighbors=(16,) * 4, first_features_dim=32, gather_transpose="banded")
    runs = jitter_witness(deeper, 3, range(1, 7))
    assert any(flips > 0 and worst > 1.0 for flips, _, worst in runs)
    three = deeper.replace(architecture=THREE_LEVELS, num_points=(1024, 256, 64),
                           conv_neighbors=(16,) * 3, pool_neighbors=(16,) * 2)
    for step in (2, 3):
        assert all(worst < 0.1 for _, _, worst in jitter_witness(three, step, range(1, 5)))
