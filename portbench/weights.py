"""The benchmark's weights: drawn on the device from the run's seed in one
call, then the batch norms' running statistics calibrated by the reference
(the module that the model dict names, ``references.of``) on the whole
first batch, so that inference normalises activations as a trained network
would (calibrated on two of its spheres, points of other spheres reached
logits of 100 and more; on all five, 23 at most). Named and shaped as the
reference's ``tensors`` gives them: the port's ``state_dict``, which loads
them with ``load_state_dict(strict=True)``.

Initialisation: convolution, transposed-convolution and dense kernels
normal with variance 1 / fan-in (LeCun), KPConv weights normal with
variance 2 / (Cin·M) (KPConv-PyTorch's kaiming init of ``weights``), batch
norm scales 1 + 0.1·normal, biases 0.1·normal.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.references import of


def _scale(shape, kind) -> float:
    if kind == "conv":  # (out, in, kh, kw)
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    if kind == "deconv":  # (in, out, kh, kw)
        return 1.0 / math.sqrt(shape[0] * shape[2] * shape[3])
    if kind == "linear":  # (out, in)
        return 1.0 / math.sqrt(shape[1])
    if kind == "kpconv":  # (M, in, out)
        return math.sqrt(2.0 / (shape[0] * shape[1]))
    return 0.1


def draw(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    entries = of(model).tensors(model)
    sizes = [math.prod(shape) for _, shape, _ in entries]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind), part in zip(entries, torch.split(z, sizes)):
        if kind == "running_mean":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "running_var":
            out[name] = torch.ones(shape, device=device)
        elif kind == "bn_weight":
            out[name] = 1.0 + 0.1 * part.reshape(shape)
        else:
            out[name] = _scale(shape, kind) * part.reshape(shape)
    return out


def calibrate(model: Dict, weights: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> None:
    """Every batch norm's running statistics set, in place, to its batch
    statistics over ``batch``, by the model's reference."""
    of(model).calibrate(model, weights, batch)
