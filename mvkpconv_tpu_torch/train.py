"""Training entry point: the port's counterpart of ``bench.py``'s train
step and of ``__graft_entry__.dryrun_multichip``'s step.

``make_trainer`` builds the model with seeded weights, the optimizer with
the 2D net frozen, and the train step; ``train_steps`` runs it. Usage::

    cfg = bench_config()
    trainer = make_trainer(cfg, seed=0)   # on the first CUDA device
    batch = batch_to_device(make_batch(cfg, 4, np.random.RandomState(0)), "cuda")
    metrics = train_steps(trainer, batch, 5)  # [{'loss', 'accuracy'}, ...]
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

from mvkpconv_tpu_torch.infer import make_model
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv
from mvkpconv_tpu_torch.training.optim import make_optimizer
from mvkpconv_tpu_torch.training.steps import make_train_step

FROZEN_PREFIXES = ("net_2d",)


class Trainer(NamedTuple):
    model: MVKPConv
    optimizer: torch.optim.SGD
    step: Callable


def make_trainer(cfg, device=None, seed: int = 0) -> Trainer:
    """Model (weights from ``seed``, training mode) on ``device`` (default:
    the first CUDA device; raises without one), its optimizer and its train
    step."""
    model = make_model(cfg, device, seed).train()
    optimizer = make_optimizer(model, cfg, frozen_prefixes=FROZEN_PREFIXES)
    return Trainer(model, optimizer, make_train_step(model, cfg, optimizer))


def train_steps(trainer: Trainer, batch: Dict[str, torch.Tensor],
                steps: int) -> List[Dict[str, torch.Tensor]]:
    """Run ``steps`` train steps on one batch; the metrics of each."""
    return [trainer.step(batch) for _ in range(steps)]
