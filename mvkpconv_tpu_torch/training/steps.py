"""Train and eval steps (``mvkpconv_tpu/training/steps.py``).

A train step is the JAX package's jitted step run eagerly: the pyramid
(under ``no_grad``, for the models that take one), the forward in training
mode, the masked cross-entropy, the backward — every gather's VJP in the
mode of ``cfg.gather_transpose`` (kernel K3 for the ``banded`` modes: the
KPConv trunk's gathers, PN2's set-abstraction and interpolation gathers) —
then the clipped SGD update. Batch-norm statistics update in the forward.

``make_train_step(..., mesh=)`` is the step over a data-parallel group
(the mesh's ``data`` axis; JAX ``make_train_step(..., mesh=)``): each
process runs its slice of the batch (a DTensor leaf from
``parallel.global_batch_from_local`` is unwrapped with ``to_local()``), and
every statistic the JAX step takes over the global batch is a sum over the
group (``parallel/collectives.py``): the batch norms' means and variances,
the loss's denominator and class counts, the regularizer's denominators,
the accuracy. Each process's loss is its share of the global loss; the
model runs under ``DistributedDataParallel`` (its buffers not broadcast:
the running statistics are equal everywhere; a static graph, so that a
parameter the forward never uses, such as the UNet's logit head of an
MV-KPConv that trains its UNet, keeps no gradient, as in one process),
which averages the gradients over the group, so the backward takes the
loss times the group's size.
Clipping by value follows the all-reduce, so every process clips the same
numbers. K3's gather VJP is per sphere and runs on the local slice as it
is. A model laid out over a ``model`` axis by
``parallel.shard_parameters`` (FSDP2) is not wrapped: FSDP reduces its
sharded parameters' gradients and the step all-reduces the replicated
ones' over ``data``.

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

from typing import Callable, Dict, Optional

import torch
import torch.distributed
from torch import nn

from mvkpconv_tpu_torch import tracing
from mvkpconv_tpu_torch.infer import apply_model, model_pyramid
from mvkpconv_tpu_torch.ops.gather import gather_transpose
from mvkpconv_tpu_torch.parallel.collectives import data_parallel, global_sum, group_size
from mvkpconv_tpu_torch.training.losses import deform_regularization, segmentation_cross_entropy


def forward_backward(model: nn.Module, cfg, batch: Dict[str, torch.Tensor],
                     apply: Optional[Callable] = None, loss_scale: float = 1.0):
    """Loss (with the deformable regularizer where the architecture has
    deformable blocks) and logits of one batch in training mode, with the
    parameters' ``.grad`` filled by the backward (before any clipping) of
    the loss times ``loss_scale``; ``apply(batch, pyr)`` runs the model
    (default ``apply_model(model, ...)``). Returns ``(loss, logits)``, both
    detached."""
    model.train()
    with torch.no_grad():
        pyr = model_pyramid(model, batch)
    with gather_transpose(cfg.port_option("gather_transpose")):
        logits = apply(batch, pyr) if apply is not None else apply_model(model, batch, pyr)
        with tracing.span("backward"):
            loss = segmentation_cross_entropy(
                logits, batch["labels"], batch.get("mask"),
                class_weights=cfg.class_weights, ignore_label=cfg.ignore_label,
                label_smoothing=cfg.label_smoothing, balance=cfg.segloss_balance,
            )
            if pyr is not None and any("deform" in b for b in cfg.architecture):
                loss = loss + deform_regularization(model, cfg.repulse_extent, cfg.deform_fitting_power)
            (loss * loss_scale if loss_scale != 1.0 else loss).backward()
    return loss.detach(), logits.detach()


def accuracy(logits: torch.Tensor, labels: torch.Tensor, mask, ignore_label: int):
    """Share of valid, non-ignored points whose argmax is their label (over
    the whole batch of a data-parallel step)."""
    valid = labels != ignore_label
    if mask is not None:
        valid = valid & mask
    hit = (logits.argmax(-1) == labels) & valid
    return global_sum(hit.sum()) / global_sum(valid.sum()).clamp(min=1)


class _Apply(nn.Module):
    """``apply_model`` as a module, for ``DistributedDataParallel`` to wrap."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, pyr):
        return apply_model(self.model, batch, pyr)


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def make_train_step(model: nn.Module, cfg, optimizer: torch.optim.Optimizer, mesh=None) -> Callable:
    """``step(batch) -> {'loss', 'accuracy'}`` (0-d tensors on the batch's
    device): forward, backward and one optimizer update. With ``mesh`` the
    step runs over the processes of its ``data`` axis (see the module's
    docstring): ``batch`` is this process's slice, or DTensors of the
    global batch; the loss and accuracy returned are the global ones."""
    group, apply, replicated = None, None, []
    if mesh is not None:
        from torch.distributed.fsdp import FSDPModule
        from torch.distributed.tensor import DTensor

        group = mesh.get_group("data")
        trained = [p for g in optimizer.param_groups for p in g["params"]]
        if isinstance(model, FSDPModule):  # parallel.shard_parameters
            replicated = [p for p in trained if not isinstance(p, DTensor)]
        else:
            wrapped = _Apply(model)
            ids = {id(p) for p in trained}
            # parameters the optimizer leaves alone (a frozen UNet) take no gradient
            nn.parallel.DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
                wrapped, [n for n, p in wrapped.named_parameters() if id(p) not in ids])
            apply = nn.parallel.DistributedDataParallel(wrapped, process_group=group, broadcast_buffers=False,
                                                        static_graph=True)
    size = group_size(group)

    def step(batch):
        batch = {k: _local(v) for k, v in batch.items()}
        with tracing.span("step"), data_parallel(group):
            optimizer.zero_grad(set_to_none=True)
            loss, logits = forward_backward(model, cfg, batch, apply, loss_scale=float(size))
            for p in replicated:
                if p.grad is not None:
                    torch.distributed.all_reduce(p.grad, group=group)
                    p.grad.div_(size)
            with tracing.span("optimizer"):
                optimizer.step()
            acc = accuracy(logits, batch["labels"], batch.get("mask"), cfg.ignore_label)
            return {"loss": global_sum(loss), "accuracy": acc}

    return step


def make_eval_step(model: nn.Module, cfg) -> Callable:
    """``step(batch) -> (B, N0, C)`` per-point probabilities, eval mode."""

    @torch.inference_mode()
    def step(batch):
        with tracing.span("step"):
            model.eval()
            logits = apply_model(model, batch, model_pyramid(model, batch))
            with tracing.span("softmax"):
                return torch.softmax(logits, dim=-1)

    return step
