"""PyTorch port: the parts of the train step against the JAX package.

  * ``BatchNorm`` (flax ``nn.BatchNorm`` numerics) and ``MaskedBatchNorm`` in
    training mode: output, running statistics after one update, input
    gradient; masks with padded rows, and ``mask=None``;
  * the loss in each option against ``segmentation_cross_entropy``;
  * the optimizer against the optax chain of ``make_optimizer`` over 5
    steps (``epoch_steps=2``, so the staircase steps; a gradient above the
    clip; a frozen subtree; a deformable-offset group);
  * the metrics.

Tolerance: rtol 1e-5, atol 1e-6 (f32 reductions in another order).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from flax import linen as fnn  # noqa: E402

from mvkpconv_tpu.models import blocks as JB  # noqa: E402
from mvkpconv_tpu.training import metrics as JMet  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.losses import segmentation_cross_entropy as jax_ce  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from mvkpconv_tpu_torch.models.blocks import MaskedBatchNorm  # noqa: E402
from mvkpconv_tpu_torch.models.norm import BatchNorm  # noqa: E402
from mvkpconv_tpu_torch.training import metrics as Met  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.losses import segmentation_cross_entropy  # noqa: E402
from mvkpconv_tpu_torch.training.optim import make_optimizer  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

TOL = dict(rtol=1e-5, atol=1e-6)


def close(got, want, **tol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got, np.float64),
        np.asarray(want, np.float64), **(tol or TOL),
    )


def bn_stats(rng, c):
    return {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": (0.1 * rng.randn(c)).astype(np.float32)},
        "batch_stats": {"mean": (0.1 * rng.randn(c)).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)},
    }


def load_bn(mod, v):
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        mod.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        mod.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        mod.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    return mod.train()


def check_bn(jmod, tmod, variables, x, g, jcall, tcall):
    """Output, running statistics after one update and input gradient."""
    def f(xx):
        y, upd = jcall(jmod, variables, xx)
        return jnp.sum(y * g), (y, upd)

    (_, (y, upd)), dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(np.asarray(x)).requires_grad_(True)
    ty = tcall(tmod, tx)
    (ty * torch.from_numpy(g)).sum().backward()
    close(ty, y)
    close(tmod.running_mean, upd["batch_stats"]["mean"])
    close(tmod.running_var, upd["batch_stats"]["var"])
    close(tx.grad, dx)


@pytest.mark.parametrize("shape", [(2, 50, 3, 7), (300, 5)])
def test_flax_batchnorm_train_matches(shape):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    variables = bn_stats(rng, c)
    jmod = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    check_bn(jmod, load_bn(BatchNorm(c), variables), variables, x, g,
             lambda m, v, xx: m.apply(v, xx, mutable=["batch_stats"]),
             lambda m, xx: m(xx))


def test_flax_batchnorm_train_channel_first_and_eval():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 6, 5, 3).astype(np.float32)  # NCHW, channel axis 1
    variables = bn_stats(rng, 6)
    y, upd = fnn.BatchNorm(use_running_average=False, momentum=0.9, axis=1).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    mod = load_bn(BatchNorm(6, channel_axis=1), variables)
    close(mod(torch.from_numpy(x)), y)
    close(mod.running_var, upd["batch_stats"]["var"])
    mod.eval()
    want = fnn.BatchNorm(use_running_average=True, axis=1).apply(
        {"params": variables["params"], **upd}, jnp.asarray(x))
    close(mod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("masked", ["padded", "all-false", "none"])
def test_masked_batchnorm_train_matches(masked):
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 40, 6) * 2 - 0.5).astype(np.float32)
    g = rng.randn(2, 40, 6).astype(np.float32)
    mask = None
    if masked == "padded":
        mask = np.ones((2, 40), bool)
        mask[1, -13:] = False
        x[1, -13:] = 1e3  # padded rows must not reach the statistics
    elif masked == "all-false":
        mask = np.zeros((2, 40), bool)
    variables = bn_stats(rng, 6)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    check_bn(JB.MaskedBatchNorm(True, 0.02), load_bn(MaskedBatchNorm(6), variables), variables, x, g,
             lambda m, v, xx: m.apply(v, xx, jmask, True, mutable=["batch_stats"]),
             lambda m, xx: m(xx, tmask))


def test_masked_batchnorm_bias_only_trains():
    x = torch.randn(2, 5, 3, requires_grad=True)
    mod = MaskedBatchNorm(3, use_bn=False).train()
    mod(x, torch.ones(2, 5, dtype=torch.bool)).sum().backward()
    assert torch.equal(mod.bias.grad, torch.full((3,), 10.0))


LOSS_OPTIONS = {
    "plain": dict(),
    "mask": dict(mask=True),
    "ignore": dict(mask=True, ignore=True),
    "class_weights": dict(mask=True, ignore=True, class_weights=True),
    "label_smoothing": dict(mask=True, label_smoothing=0.1),
    "balance": dict(mask=True, ignore=True, balance="class"),
}


@pytest.mark.parametrize("option", list(LOSS_OPTIONS))
def test_loss_matches_jax(option):
    o = LOSS_OPTIONS[option]
    rng = np.random.RandomState(3)
    c = 7
    logits = (rng.randn(3, 40, c) * 2).astype(np.float32)
    labels = rng.randint(0, c - 1, (3, 40)).astype(np.int32)  # class c-1 absent
    mask = rng.rand(3, 40) > 0.2 if o.get("mask") else None
    if o.get("ignore"):
        labels[rng.rand(3, 40) < 0.2] = -1
    cw = rng.uniform(0.5, 2.0, c).astype(np.float32) if o.get("class_weights") else None
    kw = dict(ignore_label=-1, label_smoothing=o.get("label_smoothing", 0.0),
              balance=o.get("balance", "none"))
    want_fn = lambda lg: jax_ce(lg, jnp.asarray(labels), None if mask is None else jnp.asarray(mask),  # noqa: E731
                                None if cw is None else jnp.asarray(cw), **kw)
    want, dwant = jax.value_and_grad(want_fn)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = segmentation_cross_entropy(
        tl, torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask),
        None if cw is None else tuple(cw.tolist()), **kw)
    got.backward()
    close(got, want)
    close(tl.grad, dwant)


def test_optimizer_matches_optax_over_5_steps():
    cfg_kw = dict(epoch_steps=2, learning_rate=0.05, lr_decay=0.5, momentum=0.9,
                  grad_clip_value=1.0, deform_lr_factor=0.1)
    rng = np.random.RandomState(4)
    shapes = {"net_2d": {"conv": (3, 2)}, "encoder": {"w": (4,), "offset_conv": (2, 2)},
              "head": {"b": (3,)}}
    params = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))

    module = torch.nn.Module()
    for top, sub in params.items():
        m = torch.nn.Module()
        for name, v in sub.items():
            m.register_parameter(name, torch.nn.Parameter(torch.from_numpy(v.copy())))
        module.add_module(top, m)
    opt = make_optimizer(module, KPConfig(**cfg_kw), frozen_prefixes=("net_2d",))
    tx = jax_make_optimizer(JaxConfig(**cfg_kw), frozen_prefixes=("net_2d",))
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    for step in range(5):
        grads = jax.tree.map(lambda v: (rng.randn(*v.shape) * 1.5).astype(np.float32), params)
        grads["encoder"]["w"][0] = 40.0  # far above the clip
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.zero_grad()
        for top, sub in grads.items():
            for name, g in sub.items():
                getattr(getattr(module, top), name).grad = torch.from_numpy(g.copy())
        opt.step()
        for top, sub in jparams.items():
            for name, v in sub.items():
                close(getattr(getattr(module, top), name), v, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(module.net_2d.conv.detach().numpy(), params["net_2d"]["conv"])


def test_metrics_match_jax():
    rng = np.random.RandomState(5)
    c = 6
    pred = rng.randint(0, c + 2, (3, 50)).astype(np.int32)  # some out of range
    label = rng.randint(0, c - 1, (3, 50)).astype(np.int32)  # class c-1 absent
    label[rng.rand(3, 50) < 0.1] = -1
    mask = rng.rand(3, 50) > 0.1
    got = Met.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), c, torch.from_numpy(mask))
    want = np.asarray(JMet.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), c, jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(Met.iou_from_confusion(got.numpy()), JMet.iou_from_confusion(want))
    assert Met.accuracy_from_confusion(got.numpy()) == JMet.accuracy_from_confusion(want)
    props = rng.uniform(0.05, 0.3, c)
    np.testing.assert_allclose(Met.rescale_confusion_to_proportions(got.numpy(), props),
                               JMet.rescale_confusion_to_proportions(want, props))
