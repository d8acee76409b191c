"""PyTorch port: the train steps of the mvpnet fork's model kinds
(``mvpnet``, ``pn2``, ``unet2d``: ``infer.apply_model`` and
``training/steps.py``) against the JAX package's ``make_train_step`` with
the same weights (bridged by ``convert.py``) and batch, f32, on the CPU.

Contracts: ``scatter`` — the loss within 1e-5 relative (1e-4 for PN2SSG),
the BN statistics after 1 step within rtol 2e-4, atol 2e-5, the gradients
before the update and the update itself each as one vector within
``VECTOR_REL`` of JAX's norm (they follow rounding in JAX too: see there)
and, for PN2SSG and MVPNet, each tensor within ``LEAF_REL`` of its norm,
the head's bias gradient to the element tolerance; ``banded_bf16`` (the
port's K3 plain version on bf16-rounded rows, JAX's kernel in interpret
mode) — the loss within 1e-3 relative, the gradients as in ``scatter`` and
the head's bias within 5e-2; MVPNet's frozen ``net_2d`` — its parameters and BN
statistics unchanged bit for bit in both packages. PN2SSG's dropout is 0 on
both sides: JAX's dropout stream cannot be matched
(``test_torch_pn2.py`` holds the port's rate and scale). The MVPNet batch
has poses: the port selects pixels by K2's plain version, JAX takes the
same selection (``minext``) as ``knn_indices``.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.models.pn2 import PN2SSG as JaxPN2SSG  # noqa: E402
from mvkpconv_tpu.models.unet2d import UNetResNet34 as JaxUNet  # noqa: E402
from mvkpconv_tpu.ops import unproject as jax_unproject  # noqa: E402
from mvkpconv_tpu.training import losses as jax_losses  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import (  # noqa: E402
    create_train_state,
    make_apply_fn,
)
from mvkpconv_tpu.training.steps import make_train_step as jax_make_train_step  # noqa: E402
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.models.mvpnet3d import MVPNet3D  # noqa: E402
from mvkpconv_tpu_torch.models.pn2 import PN2SSG  # noqa: E402
from mvkpconv_tpu_torch.models.unet2d import UNetResNet34  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.optim import make_optimizer  # noqa: E402
from mvkpconv_tpu_torch.training.steps import forward_backward, make_train_step  # noqa: E402
from test_torch_deformable import recording  # noqa: E402
from test_torch_pn2 import SMALL_PN2, SmallJaxMVPNet3D, mvpnet_setup  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402

TOL = {"scatter": dict(rtol=2e-4, atol=2e-5), "banded_bf16": dict(rtol=5e-2, atol=5e-2)}
LOSS_REL = {"scatter": 1e-5, "banded_bf16": 1e-3, "pn2": 1e-4}
# The gradients follow rounding in both packages, so each kind's gradients
# (and the update, −lr·gradient) are held as one vector, within this share
# of JAX's norm (ROADMAP queue 3):
#  * PN2SSG (``pn2``, ``mvpnet``): its train-mode BN takes the fast variance
#    E[x²] − E[x]² of all-positive inputs, where the packages' reduction
#    orders part by ~1e-5 of an activation; the max over a centroid's 32
#    neighbors then picks another neighbor where two lie that close, and the
#    gradient goes to another point. JAX against itself under a 1e-7 weight
#    jitter moves the gradient vector by 7.6e-3 (PN2) to 2.9e-2 (MVPNet) of
#    its norm, a tensor by up to 12.5% of its largest entry, and PN2SSG's
#    by 9.8e-2 under a 1e-5 jitter, the size of that parting
#    (``test_pn2_gradients_follow_rounding_in_jax_too``); port against JAX
#    read 3.7e-2 and 1.9e-2. The loss moves with it: 1.1e-5 under a 1e-5
#    jitter; port against JAX 1.27e-5 (PN2), so 1e-4 there.
#  * The UNet (``unet2d``): JAX's f32 gradient on the CPU lies 8.1e-3 of its
#    norm from its own float64 evaluation, the port's 1.2e-5 from its own
#    (``test_unet2d_f32_gradients_against_float64``); port against JAX 8.1e-3.
VECTOR_REL = {"pn2": 5e-2, "mvpnet": 5e-2, "unet2d": 2e-2}
# One vector is dominated by its large tensors, so PN2SSG's and MVPNet's
# are also held tensor by tensor: each within this share of JAX's norm of
# it (read up to 6.1e-2 for PN2, 2.6e-2 for MVPNet; the port against itself
# under a 1e-5 weight jitter moves its worst tensor's update by 5.3e-2 and
# 8.8e-2; a tensor whose gradient goes missing reads 1). The UNet's are
# not: the biases of its transposed convolutions feed a BN, so their
# gradients are rounding noise around 0 in both packages.
LEAF_REL = 0.25
STEP = dict(num_classes=6, learning_rate=0.05, momentum=0.9, epoch_steps=100)
T = torch.from_numpy


def port_model(kind):
    if kind == "mvpnet":
        return MVPNet3D(6, dropout=0.0, **SMALL_PN2)
    if kind == "pn2":
        return PN2SSG(6, in_channels=3, dropout=0.0, **SMALL_PN2)
    return UNetResNet34(6)


@functools.lru_cache(maxsize=None)
def inputs(kind):
    """(JAX model, JAX batch, port batch, JAX variables) of a test-size
    model of ``kind``."""
    rng = np.random.RandomState(4)
    if kind == "mvpnet":
        batch, variables = mvpnet_setup()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        image_xyz, _ = jax.jit(jax_unproject.unproject_depth)(jb["depth"], jb["intrinsics"], jb["poses"])
        knn = jax.jit(functools.partial(jax_unproject.points_to_pixel_knn_projective, k=3, window=9,
                                        method="minext"))(jb["points"], image_xyz, jb["intrinsics"], jb["poses"])
        jb = {"points": jb["points"], "images": jb["images"], "labels": jb["labels"],
              "image_xyz": image_xyz, "knn_indices": knn}
        return SmallJaxMVPNet3D(6, dropout=0.0), jb, {k: T(v) for k, v in batch.items()}, variables
    if kind == "pn2":
        batch = {"points": rng.rand(2, 256, 3).astype(np.float32),
                 "features": rng.rand(2, 256, 3).astype(np.float32),
                 "labels": rng.randint(0, 6, (2, 256)).astype(np.int32)}
        model = JaxPN2SSG(6, dropout=0.0, **SMALL_PN2)
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch["points"], batch["features"]))
    else:
        batch = {"images": rng.rand(2, 24, 32, 3).astype(np.float32),
                 "labels": rng.randint(-1, 6, (2, 24, 32)).astype(np.int32)}
        model = JaxUNet(6)
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch["images"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return model, jb, {k: T(v) for k, v in batch.items()}, random_variables(shapes, seed=3)


def frozen(kind):
    return ("net_2d",) if kind == "mvpnet" else ()


@functools.lru_cache(maxsize=None)
def jax_step(kind, mode):
    """(loss, gradients before the update, variables after 1 step) of
    JAX's train step."""
    model, jb, _, variables = inputs(kind)
    jcfg = JaxConfig(**STEP, gather_transpose=mode)
    tx = recording(jax_make_optimizer(jcfg, frozen_prefixes=frozen(kind)))
    step = jax_make_train_step(make_apply_fn(model, jcfg, kind), tx, jcfg, donate=False)
    state, metrics = step(create_train_state(variables, tx), jb)
    np_tree = functools.partial(jax.tree.map, np.asarray)
    return (float(metrics["loss"]), np_tree(state.opt_state[1]),
            {"params": np_tree(state.params), "batch_stats": np_tree(state.batch_stats)})


def as_port(kind, variables):
    return load_jax_variables(port_model(kind), variables)


def worst_leaf(got, want, names):
    """(name, ‖got − want‖ / ‖want‖) of the tensor among ``names`` that is
    furthest from ``want``."""
    gaps = {n: float(np.linalg.norm(np.asarray(got[n]) - np.asarray(want[n])) / np.linalg.norm(want[n]))
            for n in names}
    worst = max(gaps, key=gaps.get)
    return worst, gaps[worst]


def vector_gap(got, want, names):
    """‖got − want‖ / ‖want‖ over the tensors ``names``, as one vector."""
    a = np.concatenate([np.asarray(got[n]).ravel() for n in names])
    b = np.concatenate([np.asarray(want[n]).ravel() for n in names])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.slow  # JAX compiles MVPNet's train step with its UNet: 16 s
def test_mvpnet_train_step_matches_jax_scatter():
    check_step("mvpnet", "scatter")


def test_pn2_train_step_matches_jax_scatter():
    check_step("pn2", "scatter")


@pytest.mark.slow  # JAX compiles the UNet's train step: 8 s
def test_unet2d_train_step_matches_jax_scatter():
    check_step("unet2d", "scatter")


@pytest.mark.slow  # JAX compiles MVPNet's train step, its K3 in interpret mode: 11 s
def test_mvpnet_train_step_matches_jax_banded_bf16():
    check_step("mvpnet", "banded_bf16")


@pytest.mark.slow  # JAX compiles PN2's train step, its K3 in interpret mode: 5 s
def test_pn2_train_step_matches_jax_banded_bf16():
    check_step("pn2", "banded_bf16")


def check_step(kind, mode):
    """See the module's docstring and ``VECTOR_REL``."""
    _, _, tb, variables = inputs(kind)
    jloss, jgrads, jafter = jax_step(kind, mode)
    cfg = KPConfig(**STEP, gather_transpose=mode)
    tol = TOL[mode]

    port = as_port(kind, variables)
    loss, _ = forward_backward(port, cfg, tb)
    loss_rel = LOSS_REL["pn2" if kind != "unet2d" and mode == "scatter" else mode]
    np.testing.assert_allclose(float(loss), jloss, rtol=loss_rel)
    want = {n: p.detach().numpy() for n, p in as_port(
        kind, {"params": jgrads, "batch_stats": variables["batch_stats"]}).named_parameters()}
    grads = {}
    for n, p in port.named_parameters():
        if n.startswith(frozen(kind)):
            assert p.grad is None, n  # the frozen UNet runs without gradients
        else:
            grads[n] = p.grad.numpy()
    trained = sorted(grads)
    assert vector_gap(grads, want, trained) <= VECTOR_REL[kind], vector_gap(grads, want, trained)
    if kind != "unet2d":
        assert worst_leaf(grads, want, trained)[1] <= LEAF_REL, worst_leaf(grads, want, trained)
    if kind != "unet2d":  # the head's bias, the mean of softmax − one-hot
        np.testing.assert_allclose(grads["net_3d.seg_logit.bias" if kind == "mvpnet" else "seg_logit.bias"],
                                   want["net_3d.seg_logit.bias" if kind == "mvpnet" else "seg_logit.bias"], **tol)
    if mode != "scatter":
        return

    port = as_port(kind, variables).train()
    start = {k: v.clone() for k, v in port.state_dict().items()}
    step = make_train_step(port, cfg, make_optimizer(port, cfg, frozen_prefixes=frozen(kind)))
    np.testing.assert_allclose(float(step(tb)["loss"]), jloss, rtol=loss_rel)
    got, after = port.state_dict(), as_port(kind, jafter).state_dict()
    assert sorted(got) == sorted(after)
    for k, v in after.items():  # the BN statistics, and the frozen UNet's parameters
        if k not in grads:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=f"state {k}", **tol)
    # the update, −lr·(clipped gradient), held as the gradient is
    moved = {n: (got[n] - start[n]).numpy() for n in trained}
    jmoved = {n: (after[n] - start[n]).numpy() for n in trained}
    assert vector_gap(moved, jmoved, trained) <= VECTOR_REL[kind], vector_gap(moved, jmoved, trained)
    if kind != "unet2d":
        assert worst_leaf(moved, jmoved, trained)[1] <= LEAF_REL, worst_leaf(moved, jmoved, trained)
    if kind == "mvpnet":  # the frozen UNet: parameters and statistics unchanged
        unet = [k for k in got if k.startswith("net_2d.")]
        assert len(unet) > 100
        assert all(torch.equal(got[k], start[k]) for k in unet)
        assert all(torch.equal(after[k], start[k]) for k in unet)
        assert not port.net_2d.training and port.net_3d.training


@pytest.mark.slow
def test_pn2_gradients_follow_rounding_in_jax_too():
    """The witness for ``VECTOR_REL``'s PN2SSG entries: JAX against itself,
    the weights jittered by 1e-7 relative, moves PN2SSG's gradient vector
    by more than 2e-3 of its norm and some tensor by more than 1e-2 of its
    largest entry (read: 7.6e-3, 6.5e-2 at fp3). At a jitter of 1e-5, the
    size by which the two packages' reduction orders part the activations
    (``VECTOR_REL``), JAX moves its own gradient vector by more than the
    5e-2 the port is held to (read 9.8e-2; 2.0e-2 at 1e-6), so the port's
    3.7e-2 against JAX lies within JAX's own spread."""
    model, jb, _, variables = inputs("pn2")
    jcfg = JaxConfig(**STEP, gather_transpose="scatter")
    apply_fn = make_apply_fn(model, jcfg, "pn2")

    def loss(params):
        logits, _ = apply_fn({"params": params, "batch_stats": variables["batch_stats"]}, jb, True,
                             ["batch_stats"])
        return jax_losses.segmentation_cross_entropy(logits, jb["labels"], None)

    grad = jax.jit(jax.grad(loss))
    g0 = jax.tree.leaves(jax.tree.map(np.asarray, grad(variables["params"])))
    readings = {}
    for jitter in (1e-7, 1e-5):
        rng = np.random.RandomState(0)
        jittered = jax.tree.map(lambda p: p * (1 + jitter * rng.randn(*p.shape)).astype(np.float32),  # noqa: B023
                                variables["params"])
        g1 = jax.tree.leaves(jax.tree.map(np.asarray, grad(jittered)))
        gap = float(np.linalg.norm(np.concatenate([(a - b).ravel() for a, b in zip(g0, g1)]))
                    / np.linalg.norm(np.concatenate([a.ravel() for a in g0])))
        readings[jitter] = (gap, max(float(np.abs(a - b).max() / np.abs(a).max()) for a, b in zip(g0, g1)))
    assert readings[1e-7][0] > 2e-3 and readings[1e-7][1] > 1e-2, readings
    assert readings[1e-5][0] > VECTOR_REL["pn2"], readings


UNET_F64 = """
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
sys.path.insert(0, {tests!r})
from test_torch_mvpnet_train import STEP, as_port, inputs
from mvkpconv_tpu.models.unet2d import UNetResNet34
from mvkpconv_tpu.training.losses import segmentation_cross_entropy
from mvkpconv_tpu_torch.training.config import KPConfig
from mvkpconv_tpu_torch.training.steps import forward_backward

_, jb, tb, variables = inputs("unet2d")
names = None

def jax_grads(dtype):
    model = UNetResNet34(6, dtype=dtype)
    v = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)

    def loss(p):
        out, _ = model.apply({{"params": p, "batch_stats": v["batch_stats"]}}, jnp.asarray(jb["images"], dtype),
                             train=True, mutable=["batch_stats"])
        return segmentation_cross_entropy(out["seg_logit"], jb["labels"], None)

    g = jax.jit(jax.grad(loss))(v["params"])
    m = as_port("unet2d", {{"params": jax.tree.map(lambda a: np.asarray(a, np.float64), g),
                           "batch_stats": variables["batch_stats"]}})
    return np.concatenate([p.detach().double().numpy().ravel() for _, p in m.named_parameters()])

def port_grads(dtype):
    m = as_port("unet2d", variables).to(dtype)
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = dtype
    forward_backward(m, KPConfig(**STEP), {{k: v.to(dtype) if v.is_floating_point() else v for k, v in tb.items()}})
    return np.concatenate([p.grad.double().numpy().ravel() for _, p in m.named_parameters()])

j32, j64 = jax_grads(jnp.float32), jax_grads(jnp.float64)
p32, p64 = port_grads(torch.float32), port_grads(torch.float64)
print(np.linalg.norm(j32 - j64) / np.linalg.norm(j64), np.linalg.norm(p32 - p64) / np.linalg.norm(p64),
      np.linalg.norm(j64 - p64) / np.linalg.norm(p64))
"""


@pytest.mark.slow  # JAX compiles the UNet's train step twice, in a process of its own (x64): 25 s
def test_unet2d_f32_gradients_against_float64():
    """The witness for ``VECTOR_REL``'s UNet entry: each package's f32
    gradient of the UNet's train-mode loss against its own float64
    evaluation. JAX's f32 lies more than 2e-3 of the norm away (read
    8.1e-3), the port's within 1e-4 (read 1.2e-5); the two float64
    evaluations within 2e-3 of each other (read 4.6e-4: the ReLU and
    max-pool choices of the f64 runs, ties included)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    tests = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(Path(tests).parent), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", UNET_F64.format(tests=tests)], capture_output=True, text=True,
                         env=env, timeout=600, check=True).stdout.split()
    jax_gap, port_gap, between = map(float, out[-3:])
    assert jax_gap > 2e-3 and port_gap < 1e-4 and between < 2e-3, (jax_gap, port_gap, between)


@pytest.mark.slow  # two ChunkDatasets and 4 port train steps at the card parity's size: 7-11 s
def test_updates_follow_rounding_in_the_port():
    """The witness for ``chip_smoke.py``'s ``check_mvpnet_parity``: at its
    configuration (2 chunks of 1024 points, 3 views of 24x32, PN2SSG's
    centroids (256, 64, 16, 4), dropout 0), one port train step on the CPU
    against the same step with the weights jittered by 1e-7 relative moves
    some parameter by more than the card's per-element allowance (rtol 1e-3,
    atol 1e-5·max|param|; read 31.5x for MVPNet, 10.8x for PN2) and the
    update vector by more than 1e-3 of its norm (read 5.6e-3, 3.5e-3), the
    loss by less than 1e-5 (read 7.9e-7, 6.7e-7)."""
    from mvkpconv_tpu_torch.data.chunks import ChunkDataset
    from mvkpconv_tpu_torch.infer import batch_to_device
    from mvkpconv_tpu_torch.tools.common import load_scenes
    from mvkpconv_tpu_torch.tools.train_mvpnet import chunk_batch
    from mvkpconv_tpu_torch.training.init import init_parameters

    small = dict(num_centroids=(256, 64, 16, 4), dropout=0.0)
    cfg = KPConfig(gather_transpose="banded", learning_rate=0.05)
    ds = ChunkDataset(load_scenes("synthetic:2", True, 3, (24, 32)), num_points=1024, num_views=3,
                      use_color_feature=True, seed=2)
    raw = ds.sample_batch(2)
    for kind, build, frozen_names in (("mvpnet", lambda: MVPNet3D(20, **small), ("net_2d",)),
                                      ("pn2", lambda: PN2SSG(20, in_channels=3, **small), ())):
        batch = batch_to_device(chunk_batch(raw, no_images=kind == "pn2"), "cpu")
        base = init_parameters(build(), 1).state_dict()
        runs = []
        for jitter in (0.0, 1e-7):
            model = build()
            model.load_state_dict(base)
            gen = torch.Generator().manual_seed(0)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + jitter * torch.randn(p.shape, generator=gen))
            start = {n: p.detach().clone() for n, p in model.named_parameters()}
            step = make_train_step(model.train(), cfg, make_optimizer(model, cfg, frozen_prefixes=frozen_names))
            loss = float(step(batch)["loss"])
            runs.append((loss, start, {n: p.detach().clone() for n, p in model.named_parameters()}))
        (loss0, start0, after0), (loss1, start1, after1) = runs
        trained = [n for n in after0 if not n.startswith(frozen_names)]
        gap = vector_gap({n: (after1[n] - start1[n]).numpy() for n in trained},
                         {n: (after0[n] - start0[n]).numpy() for n in trained}, trained)
        atol = 1e-5 * max(float(p.abs().max()) for p in after0.values())
        worst = max(float(((after1[n] - after0[n]).abs() / (1e-3 * after0[n].abs() + atol)).max()) for n in trained)
        assert abs(loss1 - loss0) / loss0 < 1e-5, (kind, loss0, loss1)
        assert worst > 1.0 and gap > 1e-3, (kind, worst, gap)
