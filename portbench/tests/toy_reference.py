"""A toy reference module for the routing tests: a per-point MLP with one
batch norm (features → hidden, batch norm, ReLU → classes) on the real
points of a padded batch (``features``, ``mask``). Model keys: ``in_dim``,
``hidden``, ``num_classes``. It keeps the contract in ``harness.py``'s
docstring and is reached only through a configuration's ``reference``."""

import torch

from portbench.counting import PEAK_F32, PEAK_TF32

EPS = 1e-5


def tensors(model):
    f, h, c = model["in_dim"], model["hidden"], model["num_classes"]
    return [("dense0.weight", (h, f), "linear"), ("bn.weight", (h,), "bn_weight"), ("bn.bias", (h,), "bias"),
            ("bn.running_mean", (h,), "running_mean"), ("bn.running_var", (h,), "running_var"),
            ("dense1.weight", (c, h), "linear"), ("dense1.bias", (c,), "bias")]


def hidden(weights, batch):
    """(the real points' rows before the batch norm, lengths)."""
    lengths = [int(n) for n in batch["mask"].sum(1).tolist()]
    x = torch.cat([batch["features"][i, :n] for i, n in enumerate(lengths)])
    return x @ weights["dense0.weight"].t(), lengths


@torch.no_grad()
def calibrate(model, weights, batch):
    h, _ = hidden(weights, batch)
    weights["bn.running_mean"] = h.mean(0)
    weights["bn.running_var"] = h.var(0, unbiased=False)


@torch.no_grad()
def logits(model, weights, batch):
    h, lengths = hidden(weights, batch)
    h = (h - weights["bn.running_mean"]) * torch.rsqrt(weights["bn.running_var"] + EPS) * weights["bn.weight"]
    h = torch.relu(h + weights["bn.bias"])
    return h @ weights["dense1.weight"].t() + weights["dense1.bias"], lengths


def peak_seconds(model, batch, train, tf32):
    rows = int(batch["mask"].sum())
    flops = 2 * rows * (model["in_dim"] * model["hidden"] + model["hidden"] * model["num_classes"])
    return (3 if train else 1) * flops / (PEAK_TF32 if tf32["matmul"] else PEAK_F32)
