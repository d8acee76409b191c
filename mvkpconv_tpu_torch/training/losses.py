"""Segmentation loss and the deformable regularizer
(``mvkpconv_tpu/training/losses.py``).

Labels arrive mapped to [0, C) with ``ignore_label`` for ignored points;
padded slots are excluded through ``mask``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from mvkpconv_tpu_torch.models.blocks import KPConvLayer


def segmentation_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    class_weights: Optional[Union[torch.Tensor, Sequence[float]]] = None,
    ignore_label: int = -1,
    label_smoothing: float = 0.0,
    balance: str = "none",
) -> torch.Tensor:
    """Mean cross-entropy over valid, non-ignored points (a scalar).

    Log-softmax in f32. ``label_smoothing`` ε mixes the NLL with the mean
    of −log p over classes, ``(1−ε)·nll + ε·mean(−log p)``.
    ``class_weights`` weigh each point by its label's weight; without them,
    ``balance='class'`` weighs by inverse in-batch class frequency,
    total / (C · count).
    """
    c = logits.shape[-1]
    valid = labels != ignore_label
    if mask is not None:
        valid = valid & mask
    safe = labels.clamp(min=0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (-logp.mean(-1))
    w = valid.float()
    if class_weights is None and balance == "class":
        counts = (F.one_hot(safe, c).float() * w[..., None]).reshape(-1, c).sum(0)
        total = counts.sum().clamp(min=1.0)
        class_weights = total / (c * counts.clamp(min=1.0))
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
        w = w * cw[safe]
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def p2p_fitting_regularizer(
    min_d2_norm: torch.Tensor,
    kp_locs_norm: torch.Tensor,
    repulse_extent: float = 1.2,
    mask: Optional[torch.Tensor] = None,
):
    """One deformable layer's (fitting, repulsion) terms.

    ``min_d2_norm`` (B, N, M): each moved kernel point's least d² to a real
    neighbor over extent²; ``kp_locs_norm`` (B, N, M, 3): the moved kernel
    points over extent; ``mask`` (B, N): the queries that count (padded rows
    leave both means). Fitting is the mean of ``min_d2_norm``; repulsion the
    mean over queries and kernel points of Σ over the other kernel points of
    min(d − ``repulse_extent``, 0)², the other point's position detached.
    """
    m_kp = min_d2_norm.shape[-1]
    if mask is None:
        w = torch.ones(min_d2_norm.shape[:-1], device=min_d2_norm.device)
    else:
        w = mask.float()
    denom = (w.sum() * m_kp).clamp(min=1.0)
    fitting = (min_d2_norm * w[..., None]).sum() / denom
    locs = kp_locs_norm
    d2 = ((locs[..., :, None, :] - locs.detach()[..., None, :, :]) ** 2).sum(-1)
    d = torch.sqrt(d2.clamp(min=1e-12))  # (B, N, M, M)
    rep = (d - repulse_extent).clamp(max=0.0) ** 2
    eye = torch.eye(locs.shape[-2], dtype=torch.bool, device=locs.device)
    rep = torch.where(eye, torch.zeros_like(rep), rep)
    repulsion = (rep.sum(-1) * w[..., None]).sum() / denom
    return fitting, repulsion


def deform_regularization(
    model: nn.Module, repulse_extent: float = 1.2, fitting_power: float = 1.0
) -> torch.Tensor:
    """power · (2·Σ fitting + Σ repulsion) over the deformable KPConv layers
    of ``model``, from what each kept at its last forward (``deform_aux``);
    0 for a model without one."""
    fitting = repulsion = 0.0
    found = False
    for mod in model.modules():
        if isinstance(mod, KPConvLayer) and mod.deformable:
            if mod.deform_aux is None:
                raise RuntimeError("a deformable KPConv layer has not run a forward yet")
            f, r = p2p_fitting_regularizer(*mod.deform_aux[:2], repulse_extent, mod.deform_aux[2])
            fitting, repulsion, found = fitting + f, repulsion + r, True
    if not found:
        return torch.zeros(())
    return fitting_power * (2.0 * fitting + repulsion)
