"""Segmentation loss (``mvkpconv_tpu/training/losses.py``).

Labels arrive mapped to [0, C) with ``ignore_label`` for ignored points;
padded slots are excluded through ``mask``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F


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
