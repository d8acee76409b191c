"""Optimizer (``mvkpconv_tpu/training/optim.py``): the JAX package's optax
chain ``multi_transform({train: clip → sgd, deform: clip → sgd·factor,
frozen: set_to_zero})`` as ``torch.optim.SGD``.

  * gradients clipped by value to ±``cfg.grad_clip_value`` before each
    update (``optax.clip``);
  * SGD with momentum ``cfg.momentum``, no dampening, no Nesterov
    (``optax.trace``: buf ← g + μ·buf, p ← p − lr·buf);
  * a per-step staircase decay, lr = ``cfg.learning_rate`` ·
    ``cfg.lr_decay`` ** (count // ``cfg.epoch_steps``), count = 0 at the
    first update (``optax.exponential_decay(staircase=True)``); the count
    is kept in each parameter group, so the optimizer's ``state_dict``
    carries it and a resumed run goes on with its schedule;
  * parameters under ``frozen_prefixes`` are left out, so never updated;
  * deformable-offset parameters (``offset_conv`` / ``offset_bias``) in a
    group at ``cfg.deform_lr_factor`` × lr.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

DEFORM_KEYWORDS = ("offset_conv", "offset_bias")


def learning_rate(cfg, count: int) -> float:
    return cfg.learning_rate * cfg.lr_decay ** (count // cfg.epoch_steps)


def _label(name: str, frozen_prefixes: Sequence[str]) -> str:
    joined = name.replace(".", "/")
    if any(joined.startswith(p) or f"/{p}" in joined for p in frozen_prefixes):
        return "frozen"
    if any(d in joined for d in DEFORM_KEYWORDS):
        return "deform"
    return "train"


def make_optimizer(model: nn.Module, cfg, frozen_prefixes: Sequence[str] = ()) -> torch.optim.SGD:
    """SGD with momentum over the unfrozen parameters; a step pre-hook sets
    each group's scheduled learning rate and clips the gradients by value."""
    groups = {"train": [], "deform": []}
    for name, p in model.named_parameters():
        label = _label(name, frozen_prefixes)
        if label != "frozen":
            groups[label].append(p)
    factors = {"train": 1.0, "deform": cfg.deform_lr_factor}
    # a model laid out by ``parallel.shard_parameters`` mixes DTensor and plain
    # parameters, which the multi-tensor (foreach) kernels do not take together
    from torch.distributed.tensor import DTensor

    foreach = False if any(isinstance(p, DTensor) for ps in groups.values() for p in ps) else None
    sgd = torch.optim.SGD(
        [{"params": ps, "lr_factor": factors[k], "count": 0} for k, ps in groups.items() if ps],
        lr=cfg.learning_rate, momentum=cfg.momentum, foreach=foreach,
    )

    def before_step(opt, args, kwargs):
        for group in opt.param_groups:
            group["lr"] = learning_rate(cfg, group["count"]) * group["lr_factor"]
            group["count"] += 1
        nn.utils.clip_grad_value_([p for g in opt.param_groups for p in g["params"]],
                                  cfg.grad_clip_value, foreach=foreach)

    sgd.register_step_pre_hook(before_step)
    return sgd
