"""Inference entry point: the port's counterpart of ``__graft_entry__.entry``'s
``fn`` and of ``bench.py``'s ``infer``.

``build_pyramid(points, mask, spec)`` then ``model(batch, pyr)``, on the
device the batch lies on. Usage::

    cfg = bench_config()
    model = make_model(cfg, device="cuda", seed=0)
    batch = batch_to_device(make_batch(cfg, 4, np.random.RandomState(0)), "cuda")
    logits = infer(model, batch)  # (B, N0, num_classes) f32
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid
from mvkpconv_tpu_torch.training.config import KPConfig
from mvkpconv_tpu_torch.training.init import init_parameters


def bench_config() -> KPConfig:
    """The configuration of ``bench.py:106-117``: MV-KPConv early fusion,
    ARCHITECTURE_DEEPER at width 128, B=4 spheres of N0=16384 points, 5
    levels, K=30, 5 views of 120×160, bf16."""
    return KPConfig(
        fusion="early", in_features_dim=66,
        num_points=(16384, 4096, 1024, 256, 64),
        conv_neighbors=(30,) * 5, pool_neighbors=(30,) * 4,
        num_views=5, image_height=120, image_width=160, batch_num=4,
        compute_dtype=torch.bfloat16,
    )


def make_model(cfg, device="cpu", seed: int = 0) -> MVKPConv:
    """An MV-KPConv in eval mode on ``device`` with weights drawn from ``seed``."""
    model = MVKPConv(cfg).to(device)
    init_parameters(model, seed)
    return model.eval()


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in batch.items()}


@torch.inference_mode()
def infer(model: MVKPConv, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits (B, N0, num_classes) of one batch: pyramid, lift, trunk, head."""
    pyr = build_pyramid(batch["points"], batch["mask"], model.cfg.pyramid_spec())
    return model(batch, pyr)
