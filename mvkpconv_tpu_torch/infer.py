"""Inference entry point: the port's counterpart of ``__graft_entry__.entry``'s
``fn`` and of ``bench.py``'s ``infer``.

``build_pyramid(points, mask, spec)`` then the model, on the device the
batch lies on. The model is built on the first CUDA device unless the
caller names another (``device="cpu"`` runs every kernel's plain version).
``make_model`` builds an MV-KPConv, or the 3D-only KPFCNN baseline where
``cfg.fusion == 'none'``, as the JAX package's tools do; ``kind`` asks for
the mvpnet fork's models (MVPNet3D, PN2SSG, the UNet alone). Usage::

    cfg = bench_config()  # or fused_config(), deform_config(), baseline_config(),
                          # fusion_config("middle") / fusion_config("late")
    model = make_model(cfg, seed=0)
    batch = batch_to_device(make_batch(cfg, 4, np.random.RandomState(0)), "cuda")
    logits = infer(model, batch)  # (B, N0, num_classes) f32
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mvkpconv_tpu_torch import tracing
from mvkpconv_tpu_torch.models.kpfcnn import KPCNN, KPFCNN
from mvkpconv_tpu_torch.models.mvkpconv import MVKPConv
from mvkpconv_tpu_torch.models.mvpnet3d import MVPNet3D
from mvkpconv_tpu_torch.models.pn2 import PN2SSG
from mvkpconv_tpu_torch.models.unet2d import UNetResNet34
from mvkpconv_tpu_torch.ops.pyramid import Pyramid, build_pyramid
from mvkpconv_tpu_torch.training.config import ARCHITECTURE_DEEPER, KPConfig
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


def fusion_config(fusion: str) -> KPConfig:
    """The bench configuration with ``fusion`` (early, middle or late): the
    same 2 base columns ⊕ 64 lifted ones, pyramid, views and width. Middle
    fusion runs two encoders (``encoder_3d`` on the base columns,
    ``encoder_2d`` on ones ⊕ the lifted features), late fusion one encoder
    on the base columns, the lifted features joined before the head."""
    return bench_config().replace(fusion=fusion)


def baseline_config() -> KPConfig:
    """The bench configuration as the 3D-only KPFCNN baseline: no 2D
    features, the batch's 2 base feature columns in."""
    return bench_config().replace(fusion="none", in_features_dim=2)


# ARCHITECTURE_DEEPER with its last two levels deformable (blocks 9–13), the
# deformable layout of KP-FCNN
DEFORM_ARCHITECTURE = ARCHITECTURE_DEEPER[:9] + (
    "resnetb_deformable", "resnetb_deformable", "resnetb_deformable_strided",
    "resnetb_deformable", "resnetb_deformable",
) + ARCHITECTURE_DEEPER[14:]


def deform_config() -> KPConfig:
    """The bench configuration with deformable KPConv in its last two levels:
    their neighbors within ``deform_radius`` (6.0 cells, 2.5 for the rigid
    levels) at the same K, and the deformable regularizer in the loss."""
    return bench_config().replace(architecture=DEFORM_ARCHITECTURE)


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


# the model families of the JAX package's ``make_apply_fn``
MODEL_KINDS = ("mvkpconv", "kpfcnn", "mvpnet", "pn2", "unet2d")
# the kinds whose models take a pyramid
PYRAMID_MODELS = (MVKPConv, KPFCNN, KPCNN)


def make_model(cfg, device=None, seed: int = 0, freeze_2d: bool = True, kind: str = None) -> nn.Module:
    """A model of ``kind`` in eval mode with weights drawn from ``seed``, on
    ``device`` (default: the first CUDA device; raises without one):
    ``mvkpconv`` (its UNet frozen unless ``freeze_2d=False``) or ``kpfcnn``
    (the default by ``cfg.fusion``, ``'none'`` for the KPFCNN); ``mvpnet``
    (MVPNet3D, UNet frozen likewise), ``pn2`` (PN2SSG on the points' 3 color
    channels) or ``unet2d`` (the UNet alone), each at the reference's widths
    and f32, as the JAX package's tools build them."""
    kind = kind or ("kpfcnn" if cfg.fusion == "none" else "mvkpconv")
    if kind == "mvkpconv":
        model = MVKPConv(cfg, freeze_2d=freeze_2d)
    elif kind == "kpfcnn":
        model = KPFCNN(cfg)
    elif kind == "mvpnet":
        model = MVPNet3D(cfg.num_classes, freeze_2d=freeze_2d, seed=seed)
    elif kind == "pn2":
        model = PN2SSG(cfg.num_classes, in_channels=3, seed=seed)
    elif kind == "unet2d":
        model = UNetResNet34(cfg.num_classes)
    else:
        raise ValueError(f"unknown model kind {kind!r}; one of {MODEL_KINDS}")
    model = model.to(resolve_device(device))
    init_parameters(model, seed)
    return model.eval()


def apply_model(model: nn.Module, batch: Dict[str, torch.Tensor], pyr: Optional[Pyramid] = None) -> torch.Tensor:
    """Logits of ``model`` on ``batch`` (JAX ``make_apply_fn``): a KPFCNN
    or a KPCNN takes the level-0 features and the pyramid, an MV-KPConv the
    whole batch and the pyramid, an MVPNet3D the whole batch, a PN2SSG the
    points and their ``features`` (if any), the UNet the images (its
    ``seg_logit``, (B, H, W, C))."""
    if isinstance(model, (KPFCNN, KPCNN)):
        return model(batch["features"], pyr)
    if isinstance(model, MVKPConv):
        return model(batch, pyr)
    if isinstance(model, MVPNet3D):
        return model(batch)
    if isinstance(model, PN2SSG):
        return model(batch["points"], batch.get("features"))
    if isinstance(model, UNetResNet34):
        return model(batch["images"])["seg_logit"]
    raise TypeError(f"no model kind for {type(model).__name__}")


def model_pyramid(model: nn.Module, batch: Dict[str, torch.Tensor]) -> Optional[Pyramid]:
    """The pyramid ``model`` takes of ``batch``, or None for a model that
    takes none (MVPNet3D, PN2SSG, the UNet)."""
    if not isinstance(model, PYRAMID_MODELS):
        return None
    return build_pyramid(batch["points"], batch["mask"], model.cfg.pyramid_spec())


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    with tracing.span("handoff"):
        return {k: torch.tensor(np.asarray(v), device=device) for k, v in batch.items()}


@torch.inference_mode()
def infer(model: nn.Module, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits of one batch: (B, N0, num_classes) per point, (B, num_classes)
    for a KPCNN, (B, H, W, num_classes) for the UNet; the pyramid, where the
    model takes one, then the model."""
    return apply_model(model, batch, model_pyramid(model, batch))
