"""PyTorch port: the MV-KPConv early-fusion train step against the JAX
package's ``make_train_step`` (``make_optimizer(frozen_prefixes=('net_2d',))``,
``make_apply_fn(model, cfg, 'mvkpconv')``, as ``bench.py`` drives it), on the
same numpy batch (with padded rows) and the same weights (bridged with
``convert.py``), in f32.

Checked: the loss, the gradients before the update, the accuracy, and the
parameters and ``batch_stats`` after 1 and after 3 steps (the JAX state is
loaded into a second port model and compared name by name). The JAX
package's banded modes run their Pallas kernel in interpret mode here; the
port's K3 runs as its plain version. Tolerances:

  * ``scatter`` and ``banded``: rtol 2e-4, atol 2e-5, what JAX holds its own
    modes to (``tests/test_gather_transpose.py``);
  * ``banded_bf16``: gradients rtol 5e-2, atol 5e-2 (bf16-rounded cotangent
    rows), the loss of each of 3 steps within 1e-3 relative;
  * bf16 ``compute_dtype``: the loss of each of 3 steps within 2e-2
    relative;
  * accuracy within 5e-3 absolute (argmax flips at near-ties).

This file runs the ``scatter`` mode and the eval step; the banded modes
and bf16 are in ``test_torch_train_banded.py``, the 5-level configuration
in ``test_torch_train_deeper.py`` (split for the test workers' time).
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv  # noqa: E402
from mvkpconv_tpu.ops.gather import gather_transpose as jax_gather_transpose  # noqa: E402
from mvkpconv_tpu.training.losses import segmentation_cross_entropy as jax_ce  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import (  # noqa: E402
    create_train_state,
    make_apply_fn,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.infer import batch_to_device  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.optim import make_optimizer  # noqa: E402
from mvkpconv_tpu_torch.training.steps import (  # noqa: E402
    forward_backward,
    make_eval_step,
    make_train_step,
)
from test_torch_slice import CONFIGS, setup  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

TOL = {
    "scatter": dict(rtol=2e-4, atol=2e-5),
    "banded": dict(rtol=2e-4, atol=2e-5),
    "banded_bf16": dict(rtol=5e-2, atol=5e-2),
}
ACC_ABS = 5e-3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _momentum(state):
    """The SGD momentum (optax ``trace``) of the 'train' group of a JAX
    train state, shaped as its params; zeros where the group has none."""
    traces = [s for s in jax.tree.leaves(state.opt_state.inner_states["train"],
                                         is_leaf=lambda x: isinstance(x, optax.TraceState))
              if isinstance(s, optax.TraceState)]
    (trace,) = traces
    return jax.tree.map(
        lambda p, t: np.zeros_like(p) if isinstance(t, optax.MaskedNode) else np.asarray(t),
        _np_tree(state.params), trace.trace,
    )


def batches(name, dtype="float32"):
    """The batch of ``setup(name)`` (its last rows padded), and in f32 the
    same batch before the padding."""
    jcfg, batch = setup(name)[:2]
    out = {"padded": batch}
    if dtype == "float32":
        out["unpadded"] = graft._make_batch(jcfg, 2, np.random.RandomState(0))
    return out


@functools.lru_cache(maxsize=None)
def jax_run(name, mode, dtype="float32"):
    """Per batch kind ('padded', 'unpadded'): (grads before the update,
    per-step [(loss, accuracy)], variables after 1 and 3 steps) of the JAX
    package. The bf16 run has no gradients and no unpadded batch."""
    jcfg0, _batch, _pyr, variables = setup(name)
    jcfg = jcfg0.replace(gather_transpose=mode, compute_dtype=jnp.dtype(dtype))
    model = JaxMVKPConv(jcfg)
    apply_fn = make_apply_fn(model, jcfg, "mvkpconv")

    def loss_of(params, b):
        logits, _ = apply_fn(
            {"params": params, "batch_stats": variables["batch_stats"]},
            b, True, ["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)},
        )
        return jax_ce(logits, b["labels"], b["mask"], ignore_label=jcfg.ignore_label)

    grad_fn = jax.jit(jax.grad(loss_of))
    tx = jax_make_optimizer(jcfg, frozen_prefixes=("net_2d",))
    step = jax_make_train_step(apply_fn, tx, jcfg, donate=False)
    out = {}
    for kind, batch in batches(name, dtype).items():
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        grads = None
        if dtype == "float32":
            with jax_gather_transpose(mode):
                grads = _np_tree(grad_fn(variables["params"], jb))
        state = create_train_state(variables, tx)
        metrics, states = [], {}
        for i in range(3):
            state, m = step(state, jb)
            metrics.append((float(m["loss"]), float(m["accuracy"])))
            states[i + 1] = {"params": _np_tree(state.params), "batch_stats": _np_tree(state.batch_stats),
                             "momentum": _momentum(state)}
        out[kind] = (grads, metrics, states)
    return out


def port_model(name, variables, dtype="float32"):
    cfg = KPConfig(**CONFIGS[name], compute_dtype=getattr(torch, dtype))
    return load_jax_variables(MVKPConv(cfg), variables)


def port_run(name, mode, batch, dtype="float32"):
    """(grads before the update, per-step [(loss, accuracy)], state dicts
    after 1 and 3 steps) of the port."""
    _jcfg, _batch, _pyr, variables = setup(name)
    cfg = KPConfig(**CONFIGS[name], gather_transpose=mode, compute_dtype=getattr(torch, dtype))
    tb = batch_to_device(batch, "cpu")
    model = port_model(name, variables, dtype)
    forward_backward(model, cfg, tb)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    model = port_model(name, variables, dtype)
    step = make_train_step(model, cfg, make_optimizer(model, cfg, frozen_prefixes=("net_2d",)))
    metrics, states = [], {}
    for i in range(3):
        m = step(tb)
        metrics.append((float(m["loss"]), float(m["accuracy"])))
        states[i + 1] = {k: v.clone() for k, v in model.state_dict().items()}
    return grads, metrics, states


def port_step_from(name, mode, batch, jstate):
    """The port's state dict after one step started from a JAX state
    (parameters, batch statistics and SGD momentum)."""
    cfg = KPConfig(**CONFIGS[name], gather_transpose=mode)
    assert cfg.epoch_steps > 3  # the learning rate of the first steps is the count-0 one
    model = port_model(name, variables_of(jstate))
    opt = make_optimizer(model, cfg, frozen_prefixes=("net_2d",))
    momentum = dict(port_model(name, {"params": jstate["momentum"],
                                      "batch_stats": jstate["batch_stats"]}).named_parameters())
    for n, p in model.named_parameters():
        if not n.startswith("net_2d."):
            opt.state[p]["momentum_buffer"] = momentum[n].detach().clone()
    make_train_step(model, cfg, opt)(batch_to_device(batch, "cpu"))
    return model.state_dict()


def variables_of(jstate):
    return {"params": jstate["params"], "batch_stats": jstate["batch_stats"]}


def as_port_state(name, jstate):
    return port_model(name, variables_of(jstate)).state_dict()


def assert_tensors_close(got, want, tol, what):
    for key, w in want.items():
        np.testing.assert_allclose(
            got[key].detach().float().numpy(), w.detach().float().numpy(),
            err_msg=f"{what}: {key}", **tol,
        )


def check_grads(name, jgrads, grads, tol, skip=()):
    _jcfg, _batch, _pyr, variables = setup(name)
    assert all(np.all(g == 0) for g in jax.tree.leaves(jgrads["net_2d"]))
    want = port_model(name, {"params": jgrads, "batch_stats": variables["batch_stats"]})
    want = {n: p for n, p in want.named_parameters() if not n.startswith("net_2d.")}
    assert sorted(grads) == sorted(want)  # the frozen 2D net has no gradient
    assert_tensors_close(grads, {k: v for k, v in want.items() if k not in skip}, tol, "grad")


# FeatureAggregation normalizes over every pixel neighbor of every point,
# padded ones included (flax BN takes no mask, in both packages). A padded
# point sits at 1e6, so its relation feature ‖Δxyz‖² is ~3e12 and dominates
# the first BN's statistics: the gradient of the first Dense carries terms
# that f32 resolves to no digit (the two packages differ by ~100% on single
# elements), and once the first update has moved that Dense, the padded
# rows' activations move ~3e12 times as much, so from the second step on
# the lifted features, and all that the trunk learns from them, follow
# rounding and not the algorithm. On the padded batch the test leaves out
# that gradient and the state after 3 steps; the unpadded batch, where
# every input is a real point, holds every gradient and the whole state
# after 1 and 3 steps to the tolerance.
PADDED_NOISE = {
    "grad": ("feat_aggreg.mlp.dense0.weight",),
    "state after 3": ("",),
}


def check_run(name, mode, states_after=(1, 3), resumed=(), noise=None):
    """``states_after``: the steps after which the state of the port's own
    run is held against JAX's; ``resumed``: the steps n after which the
    state of one port step started from JAX's state after step n − 1 is
    held against JAX's state after step n; ``noise``: more tensors to leave
    out, keyed as ``PADDED_NOISE``."""
    for kind, batch in batches(name).items():
        jgrads, jmetrics, jstates = jax_run(name, mode)[kind]
        grads, metrics, states = port_run(name, mode, batch)
        tol = TOL[mode]
        if mode == "banded_bf16":
            np.testing.assert_allclose([m[0] for m in metrics], [m[0] for m in jmetrics], rtol=1e-3)
        else:
            np.testing.assert_allclose(metrics[0][0], jmetrics[0][0], rtol=1e-5)
            np.testing.assert_allclose([m[0] for m in metrics], [m[0] for m in jmetrics], rtol=tol["rtol"])
        # an argmax flips where the two largest logits tie within rounding
        for (_, acc), (_, jacc) in zip(metrics, jmetrics):
            assert abs(acc - jacc) <= ACC_ABS, (kind, acc, jacc)
        skip = {**(PADDED_NOISE if kind == "padded" else {}), **(noise or {})}
        check_grads(name, jgrads, grads, tol, skip.get("grad", ()))
        for n in states_after:
            want = as_port_state(name, jstates[n])
            want = {k: v for k, v in want.items() if not k.startswith(skip.get(f"state after {n}", ()))}
            assert_tensors_close(states[n], want, tol, f"{kind} batch, state after {n}")
        for n in resumed:
            got = port_step_from(name, mode, batch, jstates[n - 1])
            want = as_port_state(name, jstates[n])
            want = {k: v for k, v in want.items() if not k.startswith(skip.get(f"step {n} resumed", ()))}
            assert_tensors_close(got, want, tol, f"{kind} batch, step {n} from JAX's state")


@pytest.mark.parametrize("mode", ["scatter"])
def test_train_step_small_matches_jax(mode):
    check_run("small", mode)


def test_eval_step_matches_jax():
    """Per-point probabilities in eval mode, f32: the slice's 1e-4 bound,
    on mask-valid points."""
    jcfg, batch, _pyr, variables = setup("small")
    model = JaxMVKPConv(jcfg)
    state = create_train_state(variables, jax_make_optimizer(jcfg))
    want = np.asarray(jax_make_eval_step(make_apply_fn(model, jcfg, "mvkpconv"), jcfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}))
    cfg = KPConfig(**CONFIGS["small"])
    port = port_model("small", variables).train()  # the eval step switches it
    got = make_eval_step(port, cfg)(batch_to_device(batch, "cpu"))
    assert not port.training
    valid = batch["mask"]
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=1e-5)
