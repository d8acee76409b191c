"""KPFCNN trunk built from an ``architecture`` block list, and the 3D-only
networks on it (``mvkpconv_tpu/models/kpfcnn.py``): the ``KPFCNN``
segmentation baseline and the ``KPCNN`` classifier.

The same block list drives the model here and the pyramid budgets
(ops/pyramid.py). Blocks are registered as ``block_{i}`` like the flax
scopes; the head applies UnaryBlocks with the reference's leaky-relu on the
logits layer.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mvkpconv_tpu_torch.models import blocks as B
from mvkpconv_tpu_torch.models.kernel_points import kernel_point_positions
from mvkpconv_tpu_torch.ops.pyramid import Pyramid


def plan_architecture(cfg) -> Tuple[list, list, list]:
    """Dims/radii/levels of every block (``in_dim`` the width a block is
    given: the port builds its layers from it).

    Returns (encoder_plan, decoder_plan, skip_dims); each plan entry is
    ``(block_name, in_dim, out_dim, radius, layer_ind, concat_skip)``.
    """
    layer = 0
    r = cfg.first_subsampling_dl * cfg.conv_radius
    in_dim = cfg.in_features_dim
    out_dim = cfg.first_features_dim

    encoder, skip_dims = [], []
    arch = list(cfg.architecture)
    start_i = len(arch)
    for i, block in enumerate(arch):
        if any(t in block for t in ("pool", "strided", "upsample", "global")):
            skip_dims.append(in_dim)
        if "upsample" in block:
            start_i = i
            break
        encoder.append((block, in_dim, out_dim, r, layer, False))
        in_dim = out_dim // 2 if "simple" in block else out_dim
        if "pool" in block or "strided" in block:
            layer += 1
            r *= 2
            out_dim *= 2

    decoder = []
    for j, block in enumerate(arch[start_i:]):
        concat = j > 0 and "upsample" in arch[start_i + j - 1]
        if concat:
            in_dim += skip_dims[layer]
        decoder.append((block, in_dim, out_dim, r, layer, concat))
        # an upsample keeps its input's width; the JAX package writes
        # ``out_dim`` here, which its Dense layers never read (flax infers
        # their input width). The two agree unless the encoder ends in a
        # strided block, whose doubled ``out_dim`` no block takes up.
        in_dim = in_dim if "upsample" in block else out_dim
        if "upsample" in block:
            layer -= 1
            r *= 0.5
            out_dim = out_dim // 2
    return encoder, decoder, skip_dims


def _influence_keys(plans):
    """(kind, layer) -> radius for every rigid-influence consumer (every
    simple/resnetb block; strided blocks are 'pool')."""
    needed = {}
    for plan in plans:
        for name, _i, _o, r, layer, _c in plan:
            if "simple" in name or "resnetb" in name:
                kind = "pool" if "strided" in name else "conv"
                needed[(kind, layer)] = r
    return needed


def _site(kind, layer, pyr: Pyramid):
    if kind == "pool":
        return pyr.points[layer + 1], pyr.pools[layer]
    return pyr.points[layer], pyr.neighbors[layer]


def influence_cache_bytes(cfg, needed, pyr: Pyramid) -> int:
    """Device bytes of the influence cache: one (B, Nq, K, M) tensor in
    ``cfg.compute_dtype`` per (kind, level)."""
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    total = 0
    for kind, layer in needed:
        q, inds = _site(kind, layer, pyr)
        total += q.shape[0] * q.shape[1] * inds.shape[-1] * cfg.num_kernel_points * itemsize
    return total


def build_influence_cache(cfg, plans, pyr: Pyramid):
    """Rigid KP influence weights, one per (conv|pool, level), computed once
    and shared by every conv block of the level. Stored in
    ``cfg.compute_dtype``, the dtype the contraction consumes. The device
    budget is :func:`make_influence_cache`'s to enforce."""
    cache = {}
    for (kind, layer), r in sorted(_influence_keys(plans).items()):
        extent = r * cfg.kp_extent / cfg.conv_radius
        q, inds = _site(kind, layer, pyr)
        kp = torch.from_numpy(kernel_point_positions(r, cfg.num_kernel_points)).to(q.device)
        all_w = B.rigid_influence(
            q, pyr.points[layer], inds, kp, extent,
            cfg.kp_influence, cfg.aggregation_mode,
        )
        cache[(kind, layer)] = all_w.to(cfg.compute_dtype)
    return cache


def make_influence_cache(cfg, plans, pyr: Pyramid):
    """The prebuilt cache (``influence_cache='prebuilt'``), or None — every
    block computes its own influence — for ``'none'`` or when the cache
    would exceed ``cfg.influence_cache_budget_mb``. Only then do the blocks
    reach the fused KPConv kernel (``use_pallas_kpconv``): a cache that exists
    wins, and the flag alone runs the einsum path, as in the JAX package."""
    if cfg.port_option("influence_cache") == "none":
        return None
    needed = _influence_keys(plans)
    if influence_cache_bytes(cfg, needed, pyr) > cfg.influence_cache_budget_mb * 2**20:
        return None
    return build_influence_cache(cfg, plans, pyr)


class _BlockList(nn.Module):
    """Blocks registered as ``block_{i}`` in plan order."""

    def __init__(self, cfg, plan):
        super().__init__()
        self.plan = tuple(plan)
        for i, (name, in_dim, out_dim, r, layer, _) in enumerate(self.plan):
            self.add_module(f"block_{i}", B.block_decider(name, r, in_dim, out_dim, layer, cfg))

    def _run(self, i, x, pyr, infl):
        block = getattr(self, f"block_{i}")
        if isinstance(block, B.UnaryBlock):
            return block(x, pyr.masks[self.plan[i][4]])
        if isinstance(block, (B.SimpleBlock, B.ResnetBottleneckBlock)):
            return block(x, pyr, infl)
        return block(x, pyr)


class KPFCNNEncoder(_BlockList):
    """Encoder half; returns bottleneck features + skip features."""

    def forward(self, x, pyr: Pyramid, infl=None):
        skips = []
        for i, (name, *_rest) in enumerate(self.plan):
            # skip features are recorded just before each strided block
            if any(t in name for t in ("pool", "strided")):
                skips.append(x)
            x = self._run(i, x, pyr, infl)
        return x, skips


class KPFCNNDecoder(_BlockList):
    """Decoder half with skip concatenation after each upsample."""

    def forward(self, x, skips, pyr: Pyramid, infl=None):
        skips = list(skips)
        for i, entry in enumerate(self.plan):
            if entry[5]:
                x = torch.cat([x, skips.pop()], dim=-1)
            x = self._run(i, x, pyr, infl)
        return x


class KPFCNNHead(nn.Module):
    """head_mlp + head_softmax (leaky-relu on the logits, as the reference)."""

    def __init__(self, cfg, in_dim: int):
        super().__init__()
        self.head_mlp = B.UnaryBlock(in_dim, cfg.first_features_dim, use_bn=False)
        self.head_softmax = B.UnaryBlock(cfg.first_features_dim, cfg.num_classes, use_bn=False)

    def forward(self, x, mask):
        return self.head_softmax(self.head_mlp(x, mask), mask)


class KPFCNN(nn.Module):
    """The 3D-only KPConv segmentation baseline: encoder, decoder and head on
    the level-0 features (B, N0, ``in_features_dim``) → per-point logits
    (B, N0, num_classes), f32."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        enc, dec, _ = plan_architecture(cfg)
        self.encoder = KPFCNNEncoder(cfg, enc)
        self.decoder = KPFCNNDecoder(cfg, dec)
        self.head = KPFCNNHead(cfg, dec[-1][2])

    @property
    def encoders(self) -> Tuple[KPFCNNEncoder, ...]:
        return (self.encoder,)

    def forward(self, features: torch.Tensor, pyr: Pyramid) -> torch.Tensor:
        infl = make_influence_cache(self.cfg, (self.encoder.plan, self.decoder.plan), pyr)
        x, skips = self.encoder(features.float(), pyr, infl)
        x = self.decoder(x, skips, pyr, infl)
        return self.head(x, pyr.masks[0])


class KPCNN(nn.Module):
    """The KPConv classifier: the encoder blocks of the list, which ends in
    ``global_average``, then the masked mean over the coarsest level,
    ``head_mlp`` (UnaryBlock to 1024, no BN) and ``head_softmax`` (Linear) →
    (B, num_classes) logits."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        enc, _, _ = plan_architecture(cfg)
        if not enc or enc[-1][0] != "global_average":
            raise ValueError("a KPCNN architecture ends in 'global_average'")
        self.plan = tuple(enc)
        for i, (name, in_dim, out_dim, r, layer, _) in enumerate(enc[:-1]):
            self.add_module(f"block_{i}", B.block_decider(name, r, in_dim, out_dim, layer, cfg))
        self.global_average = B.GlobalAverageBlock()
        self.head_mlp = B.UnaryBlock(enc[-1][1], 1024, use_bn=False)
        self.head_softmax = nn.Linear(1024, cfg.num_classes)

    def forward(self, features: torch.Tensor, pyr: Pyramid) -> torch.Tensor:
        infl = make_influence_cache(self.cfg, (self.plan,), pyr)
        x = features.float()
        for i in range(len(self.plan) - 1):
            block = getattr(self, f"block_{i}")
            x = block(x, pyr, infl) if isinstance(
                block, (B.SimpleBlock, B.ResnetBottleneckBlock)) else block(x, pyr)
        x = self.head_mlp(self.global_average(x, pyr))
        return self.head_softmax(x)
