"""PyTorch port: deformable and modulated KPConv against the JAX package.

The same numpy inputs and the same weights (flax variables bridged by
``convert.py``) go through both packages, on one JAX-built pyramid where a
pyramid is given. Checked:

  * ``kpconv_apply`` with kernel point offsets, with and without
    modulations, with its ``deform_aux`` (each moved kernel point's least d²
    to a real neighbor, the moved kernel points) and the gradients of all
    three with respect to offsets, modulations, features and weights;
  * a deformable ``SimpleBlock``, ``ResnetBottleneckBlock`` and strided
    block, rigid-offset and modulated, and what each layer keeps for the
    regularizer (the JAX package's sown ``intermediates``);
  * both regularizers on sown-equivalent inputs with padded query rows, and
    the gradient of the repulsion (the other point's side detached);
  * finite offset gradients where padded query rows put every neighbor on
    the center kernel point;
  * the KPFCNN train step (``make_train_step``, deformable regularizer in the
    loss) of a ``resnetb_deformable`` architecture and of a modulated one,
    against JAX's, after 1 and 3 steps, in the ``scatter`` and ``banded``
    VJP modes;
  * deformable MV-KPConv (early fusion) logits.

Tolerances: forward f32 max |Δ| ≤ 1e-4 · max |out| and bf16 ≤ 2e-2 · max
|out|; the regularizers within 1e-5 relative; the train step's loss,
gradients (``offset_conv`` and ``offset_bias`` included), accuracy and
state within the train-step contract (ROADMAP queue 3: rtol 2e-4, atol
2e-5; accuracy within 5e-3).
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.models import KPFCNN as JaxKPFCNN  # noqa: E402
from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv  # noqa: E402
from mvkpconv_tpu.models import blocks as JB  # noqa: E402
from mvkpconv_tpu.models.kernel_points import kernel_point_positions  # noqa: E402
from mvkpconv_tpu.ops.pyramid import build_pyramid as jax_build_pyramid  # noqa: E402
from mvkpconv_tpu.training import losses as JL  # noqa: E402
from mvkpconv_tpu.training.config import KPConfig as JaxConfig  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import (  # noqa: E402
    create_train_state,
    make_apply_fn,
    make_train_step as jax_make_train_step,
)
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.data.synthetic_batch import make_batch  # noqa: E402
from mvkpconv_tpu_torch.infer import batch_to_device  # noqa: E402
from mvkpconv_tpu_torch.models import blocks as B  # noqa: E402
from mvkpconv_tpu_torch.models.kpfcnn import KPFCNN  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.ops.pyramid import Pyramid  # noqa: E402
from mvkpconv_tpu_torch.training import losses as L  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.optim import make_optimizer  # noqa: E402
from mvkpconv_tpu_torch.training.steps import forward_backward, make_train_step  # noqa: E402
from test_torch_blocks import assert_close_rel  # noqa: E402
from test_torch_slice import random_variables  # noqa: E402

REL = {"float32": 1e-4, "bfloat16": 2e-2}
REG_REL = 1e-5
TOL = dict(rtol=2e-4, atol=2e-5)
ACC_ABS = 5e-3

# the architectures of tests/test_deformable.py and tests/test_modulated.py
SMALL = dict(
    fusion="none", in_features_dim=2, num_points=(256, 64), conv_neighbors=(10, 10),
    pool_neighbors=(10,), first_features_dim=16, first_subsampling_dl=0.1,
    in_radius=1.0, num_classes=8,
)
CONFIGS = {
    "deform": dict(SMALL, architecture=(
        "simple", "resnetb", "resnetb_deformable_strided", "resnetb_deformable",
        "nearest_upsample", "unary")),
    "modulated": dict(SMALL, modulated=True, architecture=(
        "simple", "resnetb_deformable_strided", "resnetb_deformable",
        "nearest_upsample", "unary")),
}


def padded_batch(cfg):
    """The synthetic batch of ``cfg``, 2 spheres, the last 24 rows padded."""
    batch = make_batch(cfg, 2, np.random.RandomState(0))
    batch["mask"][-1, -24:] = False
    batch["points"] = np.where(batch["mask"][..., None], batch["points"], np.float32(1e6))
    return batch


def torch_pyramid(jpyr):
    return Pyramid(*(tuple(torch.from_numpy(np.array(t)) for t in f) for f in jpyr))


@functools.lru_cache(maxsize=None)
def setup(name):
    """(JAX config, numpy batch, JAX pyramid, port pyramid, variables)."""
    jcfg = JaxConfig(**CONFIGS[name])
    batch = padded_batch(KPConfig(**CONFIGS[name]))
    jpyr = jax.jit(functools.partial(jax_build_pyramid, spec=jcfg.pyramid_spec()))(
        jnp.asarray(batch["points"]), jnp.asarray(batch["mask"])
    )
    feats = jnp.asarray(batch["features"])
    shapes = jax.eval_shape(lambda: JaxKPFCNN(jcfg).init(jax.random.PRNGKey(0), feats, jpyr))
    return jcfg, batch, jpyr, torch_pyramid(jpyr), random_variables(shapes)


def _apply_inputs(seed=0):
    rng = np.random.RandomState(seed)
    b, nq, ns, k, m, c = 2, 64, 80, 10, 15, 8
    q = rng.rand(b, nq, 3).astype(np.float32)
    s = rng.rand(b, ns, 3).astype(np.float32)
    inds = rng.randint(0, ns + 1, (b, nq, k)).astype(np.int32)
    inds[1, -5:] = ns  # queries with no real neighbor
    x = rng.randn(b, ns, c).astype(np.float32)
    w = (rng.randn(m, c, 5) / 5).astype(np.float32)
    kp = kernel_point_positions(0.25, m)
    offsets = (0.1 * rng.randn(b, nq, m, 3)).astype(np.float32)
    mods = (2.0 / (1.0 + np.exp(-rng.randn(b, nq, m)))).astype(np.float32)
    return (q, s, inds, x, kp, w), offsets, mods


@pytest.mark.parametrize("modulated", [False, True], ids=["offsets", "modulated"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kpconv_apply_deformed_matches_jax(dtype, modulated):
    """Output and ``deform_aux``; in f32 also the gradients of
    Σout + Σmin_d2 + Σkp_abs with respect to offsets, modulations,
    features and weights."""
    args, offsets, mods = _apply_inputs()
    cd_j, cd_t = jnp.dtype(dtype), getattr(torch, dtype)
    mods = mods if modulated else None

    def jax_fn(off, mod, x, w):
        return JB.kpconv_apply(
            *(jnp.asarray(a) for a in args[:3]), x, jnp.asarray(args[4]), w, 0.3,
            kp_offsets=off, kp_modulations=mod, compute_dtype=cd_j, return_deform_aux=True,
        )

    jin = [jnp.asarray(offsets), None if mods is None else jnp.asarray(mods),
           jnp.asarray(args[3]), jnp.asarray(args[5])]
    jout, (jd, jk) = jax.jit(jax_fn)(*jin)
    tin = [torch.tensor(a, requires_grad=True) if a is not None else None
           for a in (offsets, mods, args[3], args[5])]
    tout, (td, tk) = B.kpconv_apply(
        *(torch.from_numpy(a) for a in args[:3]), tin[2], torch.from_numpy(args[4]), tin[3], 0.3,
        kp_offsets=tin[0], kp_modulations=tin[1], compute_dtype=cd_t, return_deform_aux=True,
    )
    assert tout.dtype == torch.float32
    assert_close_rel(tout, jout, REL[dtype])
    assert_close_rel(td, jd, REL["float32"])
    np.testing.assert_array_equal(td.detach().numpy()[1, -5:], 0.0)  # no real neighbor
    np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk), rtol=0, atol=1e-6)
    if dtype != "float32":
        return
    (tout.sum() + td.sum() + tk.sum()).backward()
    live = [i for i, a in enumerate(jin) if a is not None]

    def total(*xs):
        full = list(jin)
        for i, xv in zip(live, xs):
            full[i] = xv
        out, (d, k) = jax_fn(*full)
        return out.sum() + d.sum() + k.sum()

    jgrads = jax.jit(jax.grad(total, argnums=tuple(range(len(live)))))(*(jin[i] for i in live))
    for i, g in zip(live, jgrads):
        assert_close_rel(tin[i].grad, g, REL["float32"])


def test_offset_grads_finite_with_padded_query_rows():
    """A padded query row's shadow neighbors sit at (0, 0, 0) from it, on the
    center kernel point, so d² is exactly 0 there: ``_safe_sqrt``'s
    normal-float clamp keeps ``0 · ∞`` out of the offset gradients."""
    assert float(torch.func.grad(B._safe_sqrt)(torch.tensor(0.0))) == 0.0
    assert float(torch.func.grad(B._safe_sqrt)(torch.tensor(1e-38))) == 0.0  # denormal
    np.testing.assert_allclose(float(torch.func.grad(B._safe_sqrt)(torch.tensor(0.09))), 0.5 / 0.3, rtol=1e-6)
    b, nq, ns, k, m = 1, 4, 8, 5, 15
    rng = np.random.RandomState(0)
    q = np.full((b, nq, 3), 1e6, np.float32)
    q[0, :2] = rng.randn(2, 3) * 0.3  # rows 2, 3 stay padded queries
    s = np.full((b, ns, 3), 1e6, np.float32)
    s[0, :6] = rng.randn(6, 3) * 0.3
    inds = np.full((b, nq, k), ns, np.int32)
    inds[0, :2] = rng.randint(0, 6, (2, k))
    x = np.zeros((b, ns, 4), np.float32)
    x[0, :6] = rng.randn(6, 4)
    w = (rng.randn(m, 4, 4) * 0.1).astype(np.float32)
    offsets = torch.zeros(b, nq, m, 3, requires_grad=True)
    out, (min_d2, kp_abs) = B.kpconv_apply(
        *(torch.from_numpy(a) for a in (q, s, inds, x)),
        torch.from_numpy(kernel_point_positions(1.0, m)), torch.from_numpy(w), 1.2,
        kp_offsets=offsets, return_deform_aux=True,
    )
    (out.sum() + min_d2.sum() + kp_abs.sum()).backward()
    assert torch.isfinite(offsets.grad).all()
    assert float(offsets.grad[0, :2].abs().max()) > 0  # real queries get a signal


DEFORM_BLOCKS = [
    # (name, in_dim, out_dim, radius, layer)
    ("simple_deformable", 2, 16, 0.25, 0),
    ("resnetb_deformable", 16, 32, 0.25, 0),
    ("resnetb_deformable_strided", 32, 32, 0.25, 0),
]


def _sown(intermediates, scope):
    """The JAX layer's sown (min_d2 / extent², kp_locs / extent, mask)."""
    node = intermediates
    for part in scope:
        node = node[part]
    return tuple(np.asarray(node[k][0]) for k in ("deform_min_d2", "deform_kp_locs", "deform_mask"))


@pytest.mark.parametrize("modulated", [False, True], ids=["offsets", "modulated"])
@pytest.mark.parametrize("spec", DEFORM_BLOCKS, ids=[b[0] for b in DEFORM_BLOCKS])
def test_deformable_block_matches_jax(spec, modulated):
    """Block output in eval mode (f32) and, for the regularizer, what the
    deformable layer keeps against what the JAX layer sows."""
    name, cin, cout, r, layer = spec
    _jcfg, batch, jpyr, tpyr, _ = setup("deform")
    jcfg = JaxConfig(**CONFIGS["deform"], modulated=modulated)
    cfg = KPConfig(**CONFIGS["deform"], modulated=modulated)
    x = np.random.RandomState(4).randn(2, jpyr.points[layer].shape[1], cin).astype(np.float32)
    jx = jnp.asarray(x)
    jblock = JB.block_decider(name, r, cin, cout, layer, jcfg)
    variables = random_variables(jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jx, jpyr, False, None)), 5)
    want, state = jax.jit(lambda v, xv, p: jblock.apply(v, xv, p, False, None, mutable=["intermediates"]))(
        variables, jx, jpyr)
    block = B.block_decider(name, r, cin, cout, layer, cfg).eval()
    assert block.KPConv.deformable and block.KPConv.modulated == modulated
    assert not block.KPConv.offset_conv.use_fused and not block.KPConv.offset_conv.deformable
    load_jax_variables(block, {**variables, "intermediates": state["intermediates"]})
    with torch.no_grad():
        got = block(torch.from_numpy(x), tpyr)
    out_level = layer + ("strided" in name)
    rows = np.asarray(jpyr.masks[out_level])
    assert_close_rel(got, want, REL["float32"], rows)
    jd, jl, jm = _sown(state["intermediates"], ("KPConv",))
    td, tl, tm = block.KPConv.deform_aux
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert_close_rel(td, jd, REL["float32"], rows)
    assert_close_rel(tl, jl, REL["float32"], rows)


def _regularizer_inputs(seed=0):
    rng = np.random.RandomState(seed)
    b, n, m = 2, 40, 15
    min_d2 = (rng.rand(b, n, m) ** 2).astype(np.float32)
    locs = (rng.randn(b, n, m, 3) * 0.6).astype(np.float32)  # some pairs within the extent
    mask = np.ones((b, n), bool)
    mask[1, -9:] = False
    return min_d2, locs, mask


@pytest.mark.parametrize("masked", [True, False], ids=["padded_mask", "no_mask"])
def test_regularizers_match_jax(masked):
    """Fitting and repulsion of one layer, the gradient of both with
    respect to the kernel points' positions, and their sum over a model's
    deformable layers (power · (2·Σ fitting + Σ repulsion)), within 1e-5
    relative."""
    min_d2, locs, mask = _regularizer_inputs()
    mask = mask if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    # jitted: op by op, JAX compiles each primitive on its first use
    jf, jr = jax.jit(JL.p2p_fitting_regularizer)(jnp.asarray(min_d2), jnp.asarray(locs), 1.2, jm)
    tl = torch.tensor(locs, requires_grad=True)
    tm = None if mask is None else torch.from_numpy(mask)
    tf, tr = L.p2p_fitting_regularizer(torch.from_numpy(min_d2), tl, 1.2, tm)
    np.testing.assert_allclose(float(tf), float(jf), rtol=REG_REL)
    np.testing.assert_allclose(float(tr.detach()), float(jr), rtol=REG_REL)
    assert float(jr) > 0
    (tf + tr).backward()
    jg = jax.jit(jax.grad(lambda lv: sum(JL.p2p_fitting_regularizer(jnp.asarray(min_d2), lv, 1.2, jm))))(
        jnp.asarray(locs))
    assert_close_rel(tl.grad, jg, REG_REL)
    # summed over layers, as the train step takes it
    layers = [B.KPConvLayer(4, 4, 0.25, 0.3, deformable=True) for _ in range(2)]
    sown = {}
    for i, layer in enumerate(layers):
        md, lc, _ = _regularizer_inputs(i + 1)
        layer.deform_aux = (torch.from_numpy(md), torch.from_numpy(lc), tm)
        sown[f"layer_{i}"] = {"deform_min_d2": (jnp.asarray(md),), "deform_kp_locs": (jnp.asarray(lc),),
                              **({} if jm is None else {"deform_mask": (jm,)})}
    model = torch.nn.ModuleList(layers)
    want = jax.jit(JL.deform_regularization)(sown, 1.2, 0.5)
    np.testing.assert_allclose(float(L.deform_regularization(model, 1.2, 0.5)), float(want), rtol=REG_REL)
    assert float(L.deform_regularization(torch.nn.Linear(2, 2))) == 0.0


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def recording(tx):
    """``tx`` that also keeps in its state the gradients it was last given:
    one compiled JAX train step then yields the gradients before each
    update as well (a second compile for them costs seconds)."""
    import optax

    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@functools.lru_cache(maxsize=None)
def jax_run(name, mode):
    """(loss and gradients before the first update, per-step [(loss,
    accuracy)], variables after 1 and 3 steps) of JAX's KPFCNN train step."""
    jcfg0, batch, _jpyr, _tpyr, variables = setup(name)
    jcfg = jcfg0.replace(gather_transpose=mode)
    apply_fn = make_apply_fn(JaxKPFCNN(jcfg), jcfg, "kpfcnn")
    jb = {k: jnp.asarray(batch[k]) for k in ("points", "mask", "features", "labels")}
    tx = recording(jax_make_optimizer(jcfg))
    step = jax_make_train_step(apply_fn, tx, jcfg, donate=False)
    state = create_train_state(variables, tx)
    metrics, states = [], {}
    for i in range(3):
        state, m = step(state, jb)
        metrics.append((float(m["loss"]), float(m["accuracy"])))
        states[i + 1] = {"params": _np_tree(state.params), "batch_stats": _np_tree(state.batch_stats)}
        if i == 0:
            grads = _np_tree(state.opt_state[1])
    return metrics[0][0], grads, metrics, states


def port_model(name, variables):
    return load_jax_variables(KPFCNN(KPConfig(**CONFIGS[name])), variables)


def assert_tensors_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), w.detach().numpy(),
                                   err_msg=f"{what}: {key}", **TOL)


# banded runs JAX's Pallas segment sum in interpret mode (~15 s a case); the
# port's side of it, K3's plain version, is held in the fast tier by
# test_torch_train_banded.py
@pytest.mark.parametrize("name, mode", [
    ("deform", "scatter"),
    # for the fast tier's time: the modulated layer is held there by the
    # kpconv_apply and block cases
    pytest.param("modulated", "scatter", marks=pytest.mark.slow),
    pytest.param("deform", "banded", marks=pytest.mark.slow),
    pytest.param("modulated", "banded", marks=pytest.mark.slow),
])
def test_deformable_train_step_matches_jax(name, mode):
    """The KPFCNN train step with the regularizer, 3 free-running steps from
    the same weights, each package on its own pyramid of the same padded
    batch: the loss and every gradient before the update (``offset_conv``
    and ``offset_bias`` among them), then each step's loss and accuracy and
    the state after steps 1 and 3."""
    _jcfg, batch, _jpyr, _tpyr, variables = setup(name)
    jloss, jgrads, jmetrics, jstates = jax_run(name, mode)
    cfg = KPConfig(**CONFIGS[name], gather_transpose=mode)
    tb = batch_to_device(batch, "cpu")
    model = port_model(name, variables)
    loss, _ = forward_backward(model, cfg, tb)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert any("offset_conv" in n for n in grads) and any("offset_bias" in n for n in grads)
    want = dict(port_model(name, {"params": jgrads, "batch_stats": variables["batch_stats"]})
                .named_parameters())
    assert_tensors_close(grads, want, "grad")
    model = port_model(name, variables)
    opt = make_optimizer(model, cfg)
    assert len(opt.param_groups) == 2 and opt.param_groups[1]["lr_factor"] == cfg.deform_lr_factor
    assert {id(p) for p in opt.param_groups[1]["params"]} == {
        id(p) for n, p in model.named_parameters() if "offset_" in n}
    step = make_train_step(model, cfg, opt)
    for i in range(3):
        m = step(tb)
        np.testing.assert_allclose(float(m["loss"]), jmetrics[i][0], rtol=TOL["rtol"])
        assert abs(float(m["accuracy"]) - jmetrics[i][1]) <= ACC_ABS
        if i + 1 in (1, 3):
            want = port_model(name, jstates[i + 1]).state_dict()
            assert_tensors_close(model.state_dict(), want, f"state after {i + 1}")


MV_DEFORM = dict(
    fusion="early", in_features_dim=66,
    architecture=("simple", "resnetb_deformable", "resnetb_deformable_strided",
                  "resnetb_deformable", "nearest_upsample", "unary"),
    num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
    first_features_dim=32, num_views=2, image_height=24, image_width=32,
    pixel_patch_dtype="float32",
)


# slow for the fast tier's time (a JAX compile of the UNet and the lift):
# the fast tier holds the deformable trunk (the KPFCNN cases above) and the
# lift (test_torch_slice.py) on their own
@pytest.mark.slow
@pytest.mark.parametrize("modulated", [False, True], ids=["offsets", "modulated"])
def test_deformable_mvkpconv_logits_match_jax(modulated):
    """Deformable (and modulated) MV-KPConv, early fusion, from the raw
    batch (pyramid, pixel association, UNet, lift, trunk, head): logits on
    valid points within 1e-4 · max |logit|, f32."""
    jcfg = JaxConfig(**MV_DEFORM, modulated=modulated)
    cfg = KPConfig(**MV_DEFORM, modulated=modulated)
    batch = padded_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jpyr = jax.jit(functools.partial(jax_build_pyramid, spec=jcfg.pyramid_spec()))(jb["points"], jb["mask"])
    model = JaxMVKPConv(jcfg)
    variables = random_variables(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jb, jpyr)))
    want = np.asarray(jax.jit(lambda v, b, p: model.apply(v, b, p))(variables, jb, jpyr))
    port = load_jax_variables(MVKPConv(cfg), variables).eval()
    from mvkpconv_tpu_torch.infer import infer

    got = infer(port, batch_to_device(batch, "cpu"))
    assert sum(m.deformable for m in port.modules() if isinstance(m, B.KPConvLayer)) == 3
    assert_close_rel(got, want, REL["float32"], batch["mask"])


# the modulated configuration of chip_smoke.py's parity_deform: 3 levels, the
# last two deformable
CARD_DEFORM = dict(
    fusion="early", in_features_dim=66, modulated=True, gather_transpose="banded",
    architecture=("simple", "resnetb", "resnetb_strided", "resnetb_deformable",
                  "resnetb_deformable_strided", "resnetb_deformable",
                  "nearest_upsample", "unary", "nearest_upsample", "unary"),
    num_points=(1024, 256, 64), conv_neighbors=(16,) * 3, pool_neighbors=(16,) * 2,
    first_features_dim=32, num_views=3, image_height=24, image_width=32,
)


def _step_from(cfg, batch, state, opt_state, jitter, seed=0):
    """Parameters after one step from ``state`` with every weight scaled by
    (1 + ``jitter``·N(0, 1)), and the sign of every (leaky-)ReLU input of its
    forward."""
    import copy
    from unittest import mock

    import torch.nn.functional as F
    from mvkpconv_tpu_torch.train import make_trainer, train_steps

    trainer = make_trainer(cfg, "cpu", seed=2)
    trainer.model.load_state_dict(state)
    trainer.optimizer.load_state_dict(copy.deepcopy(opt_state))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.mul_(1 + jitter * torch.randn(p.shape, generator=gen))
    signs = []

    def recording(fn):
        def call(x, *args, **kw):
            signs.append(x.detach().flatten() > 0)
            return fn(x, *args, **kw)
        return call

    with mock.patch.object(F, "relu", recording(F.relu)), \
            mock.patch.object(F, "leaky_relu", recording(F.leaky_relu)):
        train_steps(trainer, batch, 1)
    return dict(trainer.model.named_parameters()), torch.cat(signs)


def jitter_witness(cfg, step, seeds, jitter=1e-7):
    """How far step ``step`` of ``cfg``'s train step (seed-1 weights, the
    seed-1 unpadded batch of 2, as ``chip_smoke.py``'s ``check_train_parity``)
    moves when every weight of the state before it is scaled by
    (1 + ``jitter``·N(0, 1)), one draw a seed: per seed the (leaky-)ReLU
    inputs that change sign, their count, and the largest change of a
    parameter over the card's allowance (rtol 1e-3, atol 1e-5 · the largest
    |param|)."""
    import copy

    from mvkpconv_tpu_torch.train import make_trainer, train_steps

    batch = batch_to_device(make_batch(cfg, 2, np.random.RandomState(1)), "cpu")
    trainer = make_trainer(cfg, "cpu", seed=1)
    train_steps(trainer, batch, step - 1)
    state = copy.deepcopy(trainer.model.state_dict())
    opt_state = copy.deepcopy(trainer.optimizer.state_dict())
    a, signs_a = _step_from(cfg, batch, state, opt_state, 0.0)
    atol = 1e-5 * max(float(p.abs().max()) for p in a.values())
    out = []
    for seed in seeds:
        b, signs_b = _step_from(cfg, batch, state, opt_state, jitter, seed)
        worst = max(float(((b[n] - a[n]).abs() / (1e-3 * a[n].abs() + atol)).max()) for n in a)
        out.append((int((signs_a != signs_b).sum()), signs_a.numel(), worst))
        print(f"step {step}, seed {seed}: {out[-1][0]} of {out[-1][1]} inputs flip, "
              f"the worst tensor moves by {worst:.3g} x the allowance")
    return out


@pytest.mark.slow
def test_lift_relu_flips_move_the_second_deformable_step():
    """Why ``chip_smoke.py`` holds the modulated train step on the 3D-only
    trunk: with the lift, the second step of the modulated 3-level
    configuration follows rounding. From one state after step 1, a 1e-7
    relative weight jitter flips a few of the ~4.5M ReLU and leaky-ReLU
    inputs (most in FeatureAggregation, over every pixel neighbor) and moves
    a tensor by more than the card's allowance; the same trunk without the
    lift (``fusion='none'``) flips none and stays within a tenth of it."""
    ((flips, _, worst),) = jitter_witness(KPConfig(**CARD_DEFORM), 2, [0])
    assert flips > 0 and worst > 1.0
    trunk = KPConfig(**dict(CARD_DEFORM, fusion="none", in_features_dim=2))
    ((flips, _, worst),) = jitter_witness(trunk, 2, [0])
    assert flips == 0 and worst < 0.1
