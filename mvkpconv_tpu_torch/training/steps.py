"""Train and eval steps (``mvkpconv_tpu/training/steps.py``).

A train step is the JAX package's jitted step run eagerly: the pyramid
(under ``no_grad``, for the models that take one), the forward in training
mode, the masked cross-entropy, the backward — every gather's VJP in the
mode of ``cfg.gather_transpose`` (kernel K3 for the ``banded`` modes: the
KPConv trunk's gathers, PN2's set-abstraction and interpolation gathers) —
then the clipped SGD update. Batch-norm statistics update in the forward.

The model kind decides what the model is given (JAX ``make_apply_fn``,
``infer.apply_model``): a ``KPFCNN`` (``fusion='none'``) the batch's level-0
features and the pyramid, an ``MVKPConv`` the whole batch and the pyramid,
an ``MVPNet3D`` the whole batch, a ``PN2SSG`` the points and their
features, the UNet the images. A configuration with deformable blocks adds
the deformable regularizer to the loss (``losses.deform_regularization``),
as the JAX step does.

Batch dict (as the JAX step takes it): points (B, N0, 3), mask (B, N0),
features (B, N0, C), labels (B, N0) in [0, C) or ``ignore_label``, and the
fusion inputs (images, depth, intrinsics, poses, or their precomputed
forms); an MVPNet or PN2 chunk batch has no mask (chunks are resampled to
their size); a UNet batch is images (B, H, W, 3) and labels (B, H, W). The
only random numbers a step draws are PN2SSG's dropout masks, from the
model's own generator.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from mvkpconv_tpu_torch.infer import apply_model, model_pyramid
from mvkpconv_tpu_torch.ops.gather import gather_transpose
from mvkpconv_tpu_torch.training.losses import deform_regularization, segmentation_cross_entropy


def forward_backward(model: nn.Module, cfg, batch: Dict[str, torch.Tensor]):
    """Loss (with the deformable regularizer where the architecture has
    deformable blocks) and logits of one batch in training mode, with the
    parameters' ``.grad`` filled by the backward (before any clipping).
    Returns ``(loss, logits)``, both detached."""
    model.train()
    with torch.no_grad():
        pyr = model_pyramid(model, batch)
    with gather_transpose(cfg.port_option("gather_transpose")):
        logits = apply_model(model, batch, pyr)
        loss = segmentation_cross_entropy(
            logits, batch["labels"], batch.get("mask"),
            class_weights=cfg.class_weights, ignore_label=cfg.ignore_label,
            label_smoothing=cfg.label_smoothing, balance=cfg.segloss_balance,
        )
        if pyr is not None and any("deform" in b for b in cfg.architecture):
            loss = loss + deform_regularization(model, cfg.repulse_extent, cfg.deform_fitting_power)
        loss.backward()
    return loss.detach(), logits.detach()


def accuracy(logits: torch.Tensor, labels: torch.Tensor, mask, ignore_label: int):
    """Share of valid, non-ignored points whose argmax is their label."""
    valid = labels != ignore_label
    if mask is not None:
        valid = valid & mask
    hit = (logits.argmax(-1) == labels) & valid
    return hit.sum() / valid.sum().clamp(min=1)


def make_train_step(model: nn.Module, cfg, optimizer: torch.optim.Optimizer) -> Callable:
    """``step(batch) -> {'loss', 'accuracy'}`` (0-d tensors on the batch's
    device): forward, backward and one optimizer update."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss, logits = forward_backward(model, cfg, batch)
        optimizer.step()
        acc = accuracy(logits, batch["labels"], batch.get("mask"), cfg.ignore_label)
        return {"loss": loss, "accuracy": acc}

    return step


def make_eval_step(model: nn.Module, cfg) -> Callable:
    """``step(batch) -> (B, N0, C)`` per-point probabilities, eval mode."""

    @torch.inference_mode()
    def step(batch):
        model.eval()
        return torch.softmax(apply_model(model, batch, model_pyramid(model, batch)), dim=-1)

    return step
