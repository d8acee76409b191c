"""PyTorch port: the train step against the JAX package's ``make_train_step``
at the ``deeper`` configuration (ARCHITECTURE_DEEPER, 5 levels; the
``scatter`` VJP only, for time), with the checks and tolerances of
``test_torch_train_step.py``. The state after 2 and 3 steps is held step by
step: each port step starts from JAX's state (parameters, batch statistics
and momentum) after the step before. The second test shows why the state of
3 free-running steps is not held here.
"""

from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from mvkpconv_tpu_torch.infer import batch_to_device  # noqa: E402
from mvkpconv_tpu_torch.training.config import KPConfig  # noqa: E402
from mvkpconv_tpu_torch.training.optim import make_optimizer  # noqa: E402
from mvkpconv_tpu_torch.training.steps import forward_backward, make_train_step  # noqa: E402
from test_torch_slice import CONFIGS, setup  # noqa: E402
from test_torch_train_step import TOL, batches, check_run, port_model  # noqa: E402
from torch_threads import two_threads  # noqa: F401,E402  (autouse: two intra-op threads)

# The one port step from JAX's state after step 2 leaves the tolerance on
# these tensors (unpadded batch, |Δ| over the allowance: 2.48, 2.35, 1.28
# and 1.08; every other tensor within 0.76 of it). They hold the largest
# sums of the gradient, over every neighbor pair of level 0, and take the
# jumps of the second test from every level above: one port step from JAX's
# state after step 1 with the weights jittered by 1e-7 parts from the same
# step unjittered by 2.99 times the allowance on the first of them.
DEEPER_NOISE = {
    "step 3 resumed": (
        "encoder.block_0.KPConv.weights", "encoder.block_1.KPConv.weights",
        "encoder.block_2.KPConv.weights", "feat_aggreg.mlp.dense0.weight",
    ),
}
JITTER = 1e-7


def test_train_step_deeper_matches_jax():
    check_run("deeper", "scatter", states_after=(1,), resumed=(2, 3), noise=DEEPER_NOISE)


def _jittered(model, eps):
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
    return model


def _signs_and_grads(model, cfg, batch):
    """The sign of every leaky-ReLU input of one forward, and the gradients."""
    signs, relu = [], F.leaky_relu

    def recording(x, *args, **kw):
        signs.append(x.detach().flatten() > 0)
        return relu(x, *args, **kw)

    with mock.patch.object(F, "leaky_relu", recording):
        forward_backward(model, cfg, batch)
    return torch.cat(signs), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def _state_after(model, cfg, batch, steps):
    step = make_train_step(model, cfg, make_optimizer(model, cfg, frozen_prefixes=("net_2d",)))
    for _ in range(steps):
        step(batch)
    return model.state_dict()


def test_deeper_gradients_jump_at_leaky_relu_flips():
    """The deeper configuration's deep levels hold 64, 32 and 16 points per
    batch element, so one leaky-ReLU input that changes sign moves a
    gradient by percents. Scaling every weight by (1 + 1e-7·N(0, 1)) flips
    2 of ~700k leaky-ReLU inputs and moves a gradient by 5.2% of its
    tensor's largest entry (the unjittered control repeats bit for bit),
    and after 3 steps the jittered run's state leaves the tolerance on 162
    of 490 tensors, where the port against JAX leaves it on 108."""
    variables = setup("deeper")[3]
    cfg = KPConfig(**CONFIGS["deeper"], gather_transpose="scatter")
    batch = batch_to_device(batches("deeper")["unpadded"], "cpu")
    signs, grads = _signs_and_grads(port_model("deeper", variables), cfg, batch)
    again, grads_again = _signs_and_grads(port_model("deeper", variables), cfg, batch)
    assert torch.equal(signs, again)
    assert all(torch.equal(grads[n], grads_again[n]) for n in grads)

    flipped, moved = _signs_and_grads(_jittered(port_model("deeper", variables), JITTER), cfg, batch)
    flips = int((signs != flipped).sum())
    move = max(float((moved[n] - g).abs().max() / g.abs().max()) for n, g in grads.items())
    assert flips >= 1 and move >= 1e-2, (flips, move)  # 50× the gradients' rtol

    state = _state_after(port_model("deeper", variables), cfg, batch, 3)
    other = _state_after(_jittered(port_model("deeper", variables), JITTER), cfg, batch, 3)
    tol = TOL["scatter"]
    outside = sum(
        not np.allclose(other[k].numpy(), w.numpy(), **tol) for k, w in state.items() if w.is_floating_point()
    )
    assert outside >= 10, outside
