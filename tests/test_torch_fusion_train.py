"""PyTorch port: one train step of middle fusion, of late fusion and of early
fusion on the fused KPConv path (K4), against the JAX package's
``make_train_step`` from the same weights, in f32.

The batch has no padded rows (a padded point's pixel-relation feature makes
FeatureAggregation's unmasked batch statistics follow rounding in both
packages; see ``test_torch_train_step.py``, ``PADDED_NOISE``). The gather VJP
is ``scatter`` in both packages. On the K4 configuration the port's conv
blocks run the fused Function (its explicit backward: the plain ``bwd_x`` and
``wf`` versions on CPU tensors), the JAX blocks their einsum path.

Checked: the loss (1e-5 relative), the gradients before the update, the
accuracy (5e-3: argmax near-ties) and every parameter and batch statistic
after the step, to rtol 2e-4, atol 2e-5, the tolerances of
``test_torch_train_step.py``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mvkpconv_tpu.models import MVKPConv as JaxMVKPConv  # noqa: E402
from mvkpconv_tpu.ops.gather import gather_transpose as jax_gather_transpose  # noqa: E402
from mvkpconv_tpu.training.losses import segmentation_cross_entropy as jax_ce  # noqa: E402
from mvkpconv_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from mvkpconv_tpu.training.steps import (  # noqa: E402
    create_train_state,
    make_apply_fn,
    make_train_step as jax_make_train_step,
)
from mvkpconv_tpu_torch.convert import load_jax_variables  # noqa: E402
from mvkpconv_tpu_torch.infer import batch_to_device  # noqa: E402
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.optim import make_optimizer  # noqa: E402
from mvkpconv_tpu_torch.training.steps import forward_backward, make_train_step  # noqa: E402
from test_torch_fusion import CONFIGS, count_fused_calls, setup  # noqa: E402
from test_torch_train_step import ACC_ABS, TOL, _np_tree, assert_tensors_close  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

MODE = "scatter"


def jax_step(name):
    """(gradients before the update, (loss, accuracy), variables after one
    step) of the JAX package on the unpadded batch."""
    jcfg0, _batch, unpadded, _pyr, variables = setup(name)
    jcfg = jcfg0.replace(gather_transpose=MODE)
    apply_fn = make_apply_fn(JaxMVKPConv(jcfg), jcfg, "mvkpconv")
    jb = {k: jnp.asarray(v) for k, v in unpadded.items()}

    def loss_of(params):
        logits, _ = apply_fn(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb, True, ["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)},
        )
        return jax_ce(logits, jb["labels"], jb["mask"], ignore_label=jcfg.ignore_label)

    with jax_gather_transpose(MODE):
        grads = _np_tree(jax.jit(jax.grad(loss_of))(variables["params"]))
    tx = jax_make_optimizer(jcfg, frozen_prefixes=("net_2d",))
    step = jax_make_train_step(apply_fn, tx, jcfg, donate=False)
    state, m = step(create_train_state(variables, tx), jb)
    after = {"params": _np_tree(state.params), "batch_stats": _np_tree(state.batch_stats)}
    return grads, (float(m["loss"]), float(m["accuracy"])), after


def port_model(name, variables):
    return load_jax_variables(MVKPConv(KPConfig(**CONFIGS[name])), variables)


@pytest.mark.parametrize("name", ["middle", "late", "early_k4"])
def test_train_step_matches_jax(name, monkeypatch):
    _jcfg, _batch, unpadded, _pyr, variables = setup(name)
    jgrads, (jloss, jacc), jafter = jax_step(name)
    cfg = KPConfig(**CONFIGS[name], gather_transpose=MODE)
    tb = batch_to_device(unpadded, "cpu")
    tol = TOL[MODE]

    model = port_model(name, variables)
    calls = count_fused_calls(monkeypatch)
    forward_backward(model, cfg, tb)
    assert len(calls) == (4 if name == "early_k4" else 0)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert all(np.all(g == 0) for g in jax.tree.leaves(jgrads["net_2d"]))
    want = port_model(name, {"params": jgrads, "batch_stats": variables["batch_stats"]})
    want = {n: p for n, p in want.named_parameters() if not n.startswith("net_2d.")}
    assert sorted(grads) == sorted(want)  # the frozen 2D net has no gradient
    assert_tensors_close(grads, want, tol, f"{name}: grad")

    model = port_model(name, variables)
    m = make_train_step(model, cfg, make_optimizer(model, cfg, frozen_prefixes=("net_2d",)))(tb)
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    assert abs(float(m["accuracy"]) - jacc) <= ACC_ABS
    assert_tensors_close(model.state_dict(), port_model(name, jafter).state_dict(), tol,
                         f"{name}: state after 1 step")
