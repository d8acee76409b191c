"""Inference entry point: the port's counterpart of ``__graft_entry__.entry``'s
``fn`` and of ``bench.py``'s ``infer``.

``build_pyramid(points, mask, spec)`` then ``model(batch, pyr)``, on the
device the batch lies on. The model is built on the first CUDA device unless
the caller names another (``device="cpu"`` runs every kernel's plain
version). Usage::

    cfg = bench_config()            # or fused_config(), or fusion="middle" / "late"
    model = make_model(cfg, seed=0)
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


# The fused KPConv kernel runs only in blocks that get no precomputed
# influence: the flag alone, under the default prebuilt cache, runs none.
FUSED_OPTIONS = dict(use_pallas_kpconv=True, influence_cache="none")


def fused_config() -> KPConfig:
    """The bench configuration on the fused KPConv path: every rigid block
    recomputes its influence inside kernel K4 and no (B, N, K, M) tensor is
    kept."""
    return bench_config().replace(**FUSED_OPTIONS)


def resolve_device(device=None) -> torch.device:
    """``device``, or the first CUDA device when none is named; raises where
    that default has no card to run on."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller asks "
            "for device='cpu' (the kernels' plain versions)"
        )
    return torch.device("cuda", 0)


def make_model(cfg, device=None, seed: int = 0) -> MVKPConv:
    """An MV-KPConv in eval mode with weights drawn from ``seed``, on
    ``device`` (default: the first CUDA device; raises without one)."""
    model = MVKPConv(cfg).to(resolve_device(device))
    init_parameters(model, seed)
    return model.eval()


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in batch.items()}


@torch.inference_mode()
def infer(model: MVKPConv, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits (B, N0, num_classes) of one batch: pyramid, lift, trunk, head."""
    pyr = build_pyramid(batch["points"], batch["mask"], model.cfg.pyramid_spec())
    return model(batch, pyr)
