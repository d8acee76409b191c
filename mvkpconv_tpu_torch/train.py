"""Training entry point: the port's counterpart of ``bench.py``'s train
step and of ``__graft_entry__.dryrun_multichip``'s step.

``make_trainer`` builds the model with seeded weights (an MV-KPConv, or the
KPFCNN baseline where ``cfg.fusion == 'none'``; or the ``kind`` asked for:
``mvpnet``, ``pn2``, ``unet2d``), the optimizer (with the 2D
net frozen unless ``freeze_2d=False``) and the train step, as a
``TrainSetup``; ``train_steps`` runs it. The training loop with data,
validation and checkpoints is ``training.trainer.Trainer``, driven by
``tools/train_scannet.py``. Usage::

    cfg = bench_config()
    trainer = make_trainer(cfg, seed=0)   # on the first CUDA device
    batch = batch_to_device(make_batch(cfg, 4, np.random.RandomState(0)), "cuda")
    metrics = train_steps(trainer, batch, 5)  # [{'loss', 'accuracy'}, ...]
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch
from torch import nn

from mvkpconv_tpu_torch.infer import make_model
from mvkpconv_tpu_torch.training.optim import make_optimizer
from mvkpconv_tpu_torch.training.steps import make_train_step

FROZEN_PREFIXES = ("net_2d",)


class TrainSetup(NamedTuple):
    model: nn.Module
    optimizer: torch.optim.SGD
    step: Callable


def make_trainer(cfg, device=None, seed: int = 0, freeze_2d: bool = True, kind: str = None) -> TrainSetup:
    """Model of ``kind`` (``infer.make_model``; weights from ``seed``,
    training mode) on ``device`` (default: the first CUDA device; raises
    without one), its optimizer and its train step. ``freeze_2d=False``
    trains an MV-KPConv's or MVPNet's UNet end to end (BN batch statistics,
    gradients through the lift)."""
    model = make_model(cfg, device, seed, freeze_2d=freeze_2d, kind=kind).train()
    optimizer = make_optimizer(model, cfg, frozen_prefixes=FROZEN_PREFIXES if freeze_2d else ())
    return TrainSetup(model, optimizer, make_train_step(model, cfg, optimizer))


def train_steps(trainer: TrainSetup, batch: Dict[str, torch.Tensor],
                steps: int) -> List[Dict[str, torch.Tensor]]:
    """Run ``steps`` train steps on one batch; the metrics of each."""
    return [trainer.step(batch) for _ in range(steps)]
