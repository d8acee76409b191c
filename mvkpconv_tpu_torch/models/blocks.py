"""KPConv network blocks (``mvkpconv_tpu/models/blocks.py``).

Dense batched layout ``(B, N, C)``, shadow neighbor indices (== N_support ⇒
zero feature row), masked batch norm and the KPConv math of the JAX
package. Submodules carry the flax scope names (``KPConv``, ``bn``,
``unary1``, ``mlp`` …) so the weight bridge is a name-for-name walk.

Numerics follow the JAX package op by op:
  * ``compute_dtype``: the KP contraction (B,Nq,K,M)×(B,Nq,K,C) and its
    (M·Cin, Cout) product — operands rounded to ``compute_dtype``, products
    accumulated in f32, the output f32. The fused kernel
    (``use_pallas_kpconv``) rounds only the gathered features to
    ``compute_dtype``: its influence and its weights stay f32, as in the JAX
    package's fused branch;
  * float32: ``UnaryBlock``'s Dense, ``MaskedBatchNorm`` and all geometry
    (rigid influence and its distances).
Blocks read ``self.training``: batch norm takes the masked batch statistics
in training mode. Every feature gather goes through ``group_points``, whose
backward is the gather-transpose mode in scope at the forward.

With ``cfg.remat == 'blocks'`` each rigid conv block (``simple*``,
``resnetb*``) runs under ``torch.utils.checkpoint`` in training: its
internals (the gathered (B, Nq, K, C) neighbor features, the contraction)
are recomputed in the backward instead of kept, as the JAX package wraps
the same blocks in ``nn.remat``. The recompute does not update the BN
running statistics again, so they move once a step as with flax's
functional collections. It only regenerates saved tensors: the backward
runs the graph of the first forward, so each gather's VJP keeps the mode
and the K3 plans it recorded (K3 launches once a gather either way; a
fused block's K4 forward launches twice).

Deformable blocks (``*_deformable*`` names) predict per-query kernel point
offsets (and, with ``cfg.modulated``, per-kernel-point modulations) with a
rigid offset conv, then convolve with the deformed kernel points; each
deformable ``KPConvLayer`` keeps what the fitting regularizer needs
(``training/losses.py:deform_regularization``) on itself.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mvkpconv_tpu_torch.models.kernel_points import kernel_point_positions
from mvkpconv_tpu_torch.ops.gather import group_points, pad_shadow_row
from mvkpconv_tpu_torch.ops.kernels.kpconv import kpconv_fused
from mvkpconv_tpu_torch.parallel.collectives import current_group, global_sum, global_sums


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (B, Ns, C) features at (B, Nq, K) indices with shadow → 0."""
    return group_points(pad_shadow_row(x), idx)


def max_pool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Max over neighbor features; shadow slots contribute zeros."""
    return gather_neighbors(x, idx).amax(dim=-2)


def closest_pool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Features of the closest (first) neighbor. A one-neighbor index (the
    pyramid's upsamples) is gathered as it is, so its K3 plans serve."""
    return gather_neighbors(x, idx if idx.shape[-1] == 1 else idx[..., :1])[..., 0, :]


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with value 0 (and a finite gradient) at x ≤ 1e-30: padded rows
    put neighbors exactly on the center kernel point."""
    return torch.where(x > 1e-30, torch.sqrt(x.clamp(min=1e-30)), torch.zeros_like(x))


def _kp_sq_dists(neighbors: torch.Tensor, kernel_pts: torch.Tensor) -> torch.Tensor:
    """(B,Nq,K,M) squared distances |n − y|² = |n|² − 2 n·y + |y|², f32."""
    kp = kernel_pts.float()
    cross = torch.matmul(neighbors.float(), kp.t())
    n2 = (neighbors * neighbors).sum(dim=-1)
    y2 = (kp * kp).sum(dim=-1)
    return (n2[..., None] - 2.0 * cross + y2).clamp(min=0.0)


def _influence(sq, kp_extent: float, influence: str, aggregation: str):
    if influence == "constant":
        all_w = torch.ones_like(sq)
    elif influence == "linear":
        all_w = (1.0 - _safe_sqrt(sq) / kp_extent).clamp(min=0.0)
    elif influence == "gaussian":
        sigma = kp_extent * 0.3
        all_w = torch.exp(-sq / (2.0 * sigma**2))
    else:
        raise ValueError(f"unknown KP influence {influence!r}")
    if aggregation == "closest":
        closest = torch.argmin(sq, dim=-1)
        all_w = all_w * F.one_hot(closest, sq.shape[-1]).to(all_w.dtype)
    elif aggregation != "sum":
        raise ValueError(f"unknown aggregation mode {aggregation!r}")
    return all_w


def rigid_influence(
    q_pts, s_pts, neighb_inds, kernel_pts, kp_extent: float,
    influence: str = "linear", aggregation: str = "sum",
) -> torch.Tensor:
    """Rigid KP influence weights (B, Nq, K, M), f32, shared by every rigid
    conv block of a pyramid level. Shadow neighbors land on a +1e6 support
    row and get zero influence."""
    s_pad = torch.cat([s_pts, torch.full_like(s_pts[:, :1], 1e6)], dim=1)
    neighbors = group_points(s_pad, neighb_inds) - q_pts[:, :, None, :]
    return _influence(_kp_sq_dists(neighbors, kernel_pts), kp_extent, influence, aggregation)


def _contract(all_w, nx, weights, compute_dtype, modulations=None):
    """einsum 'bqkm,bqkc->bqmc' then the (M·Cin, Cout) product, both with
    operands in ``compute_dtype`` and f32 accumulation; f32 out. Modulations
    (B, Nq, M) scale each kernel point's weighted sum, in f32, before the
    product."""
    m, cin, cout = weights.shape
    wf = torch.einsum(
        "bqkm,bqkc->bqmc", all_w.to(compute_dtype), nx.to(compute_dtype)
    )  # f32-accumulated; a bf16 result is the f32 sum rounded once
    if modulations is not None:
        wf = wf.float() * modulations[..., None].float()
    wf = wf.reshape(wf.shape[0], wf.shape[1], m * cin).to(compute_dtype).float()
    return torch.matmul(wf, weights.reshape(m * cin, cout).to(compute_dtype).float())


def kpconv_apply(
    q_pts: torch.Tensor,
    s_pts: torch.Tensor,
    neighb_inds: torch.Tensor,
    x: torch.Tensor,
    kernel_pts: torch.Tensor,
    weights: torch.Tensor,
    kp_extent: float,
    influence: str = "linear",
    aggregation: str = "sum",
    compute_dtype: torch.dtype = torch.float32,
    precomputed_influence: Optional[torch.Tensor] = None,
    use_fused: bool = False,
    kp_offsets: Optional[torch.Tensor] = None,
    kp_modulations: Optional[torch.Tensor] = None,
    return_deform_aux: bool = False,
):
    """Kernel point convolution → (B, Nq, Cout) f32.

    With ``precomputed_influence`` (B, Nq, K, M) the geometry is skipped
    (features-only gather + contraction); otherwise positions ⊕ features
    ride one gather and the influence is computed here: by the fused kernel
    (``ops/kernels/kpconv.py``) with ``use_fused``, linear influence and sum
    aggregation, else by the einsum path. A precomputed influence wins over
    ``use_fused``, as in the JAX package. The points carry no gradient (the
    pyramid is an input), so the fused kernel gets the neighbor offsets
    detached.

    Deformable: ``kp_offsets`` (B, Nq, M, 3) move the kernel points per
    query, and the squared distances are the explicit differences to the
    moved points; ``kp_modulations`` (B, Nq, M) scale each kernel point's
    weighted sum. A deformed call ignores ``precomputed_influence`` and
    ``use_fused``. With ``return_deform_aux`` it returns ``(out, (min_d2,
    kp_abs))``: each (moved) kernel point's least d² to a real neighbor
    (B, Nq, M; 0 where a query has none) and the moved kernel points
    (B, Nq, M, 3).
    """
    rigid = kp_offsets is None and not return_deform_aux
    if precomputed_influence is not None and rigid:
        nx = group_points(pad_shadow_row(x), neighb_inds)
        return _contract(precomputed_influence, nx, weights, compute_dtype, kp_modulations)
    s_pad = torch.cat([s_pts, torch.full_like(s_pts[:, :1], 1e6)], dim=1)
    payload = torch.cat([s_pad, pad_shadow_row(x.to(s_pts.dtype))], dim=-1)
    gathered = group_points(payload, neighb_inds)
    neighbors = gathered[..., :3] - q_pts[:, :, None, :]
    if (use_fused and rigid and kp_modulations is None
            and influence == "linear" and aggregation == "sum"):
        m, cin, cout = weights.shape
        return kpconv_fused(
            neighbors.detach(), gathered[..., 3:].to(compute_dtype), kernel_pts.float(),
            weights.reshape(m * cin, cout).float(), float(kp_extent),
        )
    kp = kernel_pts.float()
    if kp_offsets is not None:
        kp = kp + kp_offsets  # (B, Nq, M, 3)
        diff = neighbors[..., None, :] - kp[:, :, None]  # (B, Nq, K, M, 3)
        sq = (diff * diff).sum(dim=-1)
    else:
        sq = _kp_sq_dists(neighbors, kernel_pts)
    all_w = _influence(sq, kp_extent, influence, aggregation)
    out = _contract(all_w, gathered[..., 3:], weights, compute_dtype, kp_modulations)
    if not return_deform_aux:
        return out
    # amin, as jnp.min, splits the cotangent evenly between tied neighbors
    real = (neighb_inds < s_pts.shape[1])[..., None]
    min_d2 = torch.where(real, sq, torch.full_like(sq, float("inf"))).amin(dim=-2)
    min_d2 = torch.where(torch.isfinite(min_d2), min_d2, torch.zeros_like(min_d2))
    return out, (min_d2, kp.expand(*sq.shape[:2], *kernel_pts.shape))


# False while a checkpointed block recomputes its forward in the backward
_BN_UPDATES: contextvars.ContextVar[bool] = contextvars.ContextVar("bn_updates", default=True)


@contextlib.contextmanager
def _recompute():
    """The recompute of a checkpointed block: no running-statistics update."""
    token = _BN_UPDATES.set(False)
    try:
        yield
    finally:
        _BN_UPDATES.reset(token)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid points only: ``(x - mean) * rsqrt(var + eps) *
    scale + bias`` in f32. With ``use_bn=False`` it is a bias only.

    Eval uses the running statistics. Train takes the masked mean and the
    masked biased variance over every axis but the channel, with
    ``count = max(Σ mask, 1)`` (the plain mean and biased variance when
    ``mask`` is None), over the whole batch of a data-parallel step
    (``parallel/collectives.py``), lets gradients flow through them, and updates the
    running statistics as ``ra ← (1 − m)·ra + m·batch`` with the
    reference's torch-style momentum m = ``cfg.batch_norm_momentum``
    (0.02), except in a checkpointed block's recompute."""

    def __init__(self, num_features: int, use_bn: bool = True, epsilon: float = 1e-5,
                 momentum: float = 0.02):
        super().__init__()
        self.use_bn = use_bn
        self.epsilon = epsilon
        self.momentum = momentum
        self.bias = nn.Parameter(torch.zeros(num_features))
        if use_bn:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.register_buffer("running_mean", torch.zeros(num_features))
            self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if not self.use_bn:
            return x + self.bias
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if mask is None and current_group() is None:
                mean = x.mean(dims)
                var = ((x - mean) ** 2).mean(dims)
            else:
                # over a data-parallel group: Σx and the count summed over it,
                # then Σ((x − mean)·m)²
                m = torch.ones_like(x[..., :1]) if mask is None else mask.to(x.dtype)[..., None]
                total, count = global_sums((x * m).sum(dims), m.sum().reshape(1))
                count = count.reshape(()).clamp(min=1.0)
                mean = total / count
                var = global_sum((((x - mean) * m) ** 2).sum(dims)) / count
            if _BN_UPDATES.get():
                with torch.no_grad():
                    mo = self.momentum
                    self.running_mean.mul_(1.0 - mo).add_(mo * mean)
                    self.running_var.mul_(1.0 - mo).add_(mo * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.epsilon) * self.weight + self.bias


class UnaryBlock(nn.Module):
    """1×1 MLP (f32) + masked BN + LeakyReLU(0.1)."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = True,
                 no_relu: bool = False, bn_momentum: float = 0.02):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)
        self.bn = MaskedBatchNorm(out_dim, use_bn, momentum=bn_momentum)
        self.no_relu = no_relu

    def forward(self, x, mask=None):
        x = self.bn(self.mlp(x.float()), mask)
        return x if self.no_relu else F.leaky_relu(x, 0.1)


class KPConvLayer(nn.Module):
    """The learned KPConv op: kernel points + (M, Cin, Cout) weights.

    Kernel points span ``radius`` (the unit disposition times the conv
    radius); ``kp_extent`` sets the influence width. ``use_fused`` sends a
    rigid call that gets no precomputed influence through the fused kernel.

    ``deformable`` adds ``offset_conv``, a rigid KPConvLayer of width M·3
    (M·4 with ``modulated``) that takes the level's cached influence and is
    never fused, and ``offset_bias``; its output (+ bias) times ``kp_extent``
    moves the kernel points per query, and with ``modulated`` its last M
    columns give the modulations 2·sigmoid(·). The deformed conv itself gets
    no cached influence. Each forward keeps ``deform_aux`` = (min d² /
    extent², moved kernel points / extent, query mask) for the fitting
    regularizer, as the reference keeps ``min_d2`` / ``deformed_KP`` on the
    module.
    """

    def __init__(self, in_dim: int, out_dim: int, radius: float,
                 kp_extent: float, num_kernel_points: int = 15,
                 influence: str = "linear", aggregation: str = "sum",
                 compute_dtype: torch.dtype = torch.float32, use_fused: bool = False,
                 deformable: bool = False, modulated: bool = False):
        super().__init__()
        self.use_fused = use_fused
        self.kp_extent = kp_extent
        self.influence = influence
        self.aggregation = aggregation
        self.compute_dtype = compute_dtype
        self.deformable = deformable
        self.modulated = modulated
        kp = kernel_point_positions(radius, num_kernel_points)
        self.register_buffer("kernel_pts", torch.from_numpy(kp), persistent=False)
        self.weights = nn.Parameter(torch.zeros(num_kernel_points, in_dim, out_dim))
        self.deform_aux = None
        if deformable:
            width = num_kernel_points * (4 if modulated else 3)
            self.offset_conv = KPConvLayer(
                in_dim, width, radius, kp_extent, num_kernel_points,
                influence, aggregation, compute_dtype,
            )
            self.offset_bias = nn.Parameter(torch.zeros(width))

    def forward(self, q_pts, s_pts, neighb_inds, x, precomputed_influence=None, q_mask=None):
        if not self.deformable:
            return kpconv_apply(
                q_pts, s_pts, neighb_inds, x, self.kernel_pts, self.weights,
                self.kp_extent, self.influence, self.aggregation,
                compute_dtype=self.compute_dtype,
                precomputed_influence=precomputed_influence,
                use_fused=self.use_fused,
            )
        off = self.offset_conv(q_pts, s_pts, neighb_inds, x, precomputed_influence) + self.offset_bias
        b, nq = off.shape[:2]
        m = self.kernel_pts.shape[0]
        offsets = off[..., : m * 3].reshape(b, nq, m, 3) * self.kp_extent
        modulations = 2.0 * torch.sigmoid(off[..., m * 3:]) if self.modulated else None
        out, (min_d2, kp_abs) = kpconv_apply(
            q_pts, s_pts, neighb_inds, x, self.kernel_pts, self.weights,
            self.kp_extent, self.influence, self.aggregation,
            compute_dtype=self.compute_dtype,
            kp_offsets=offsets, kp_modulations=modulations, return_deform_aux=True,
        )
        self.deform_aux = (min_d2 / self.kp_extent**2, kp_abs / self.kp_extent, q_mask)
        return out


def _conv_site(block_name: str, layer: int, pyr):
    """(query points, neighbor indices, output mask, influence key)."""
    if "strided" in block_name:
        return pyr.points[layer + 1], pyr.pools[layer], pyr.masks[layer + 1], ("pool", layer)
    return pyr.points[layer], pyr.neighbors[layer], pyr.masks[layer], ("conv", layer)


def _kpconv_layer(cfg, block_name, in_dim, out_dim, radius):
    cfg.port_option("kpconv_tail")  # every tail form is the einsum contraction here
    return KPConvLayer(
        in_dim, out_dim, radius,
        kp_extent=radius * cfg.kp_extent / cfg.conv_radius,
        num_kernel_points=cfg.num_kernel_points,
        influence=cfg.kp_influence,
        aggregation=cfg.aggregation_mode,
        compute_dtype=cfg.compute_dtype,
        use_fused=cfg.port_option("use_pallas_kpconv"),
        deformable="deform" in block_name,
        modulated=cfg.modulated,
    )


class _ConvBlock(nn.Module):
    """A block around one KPConv layer; with ``cfg.remat == 'blocks'`` a
    rigid one runs ``_forward`` under ``torch.utils.checkpoint`` when a
    gradient is recorded."""

    def __init__(self, block_name, layer_ind, cfg):
        super().__init__()
        self.block_name, self.layer_ind = block_name, layer_ind
        self.remat = cfg.port_option("remat") == "blocks" and "deform" not in block_name

    def forward(self, x, pyr, infl=None):
        if not (self.remat and torch.is_grad_enabled()):
            return self._forward(x, pyr, infl)
        return torch.utils.checkpoint.checkpoint(
            self._forward, x, pyr, infl, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), _recompute()),
        )


class SimpleBlock(_ConvBlock):
    """KPConv → BN → LeakyReLU, output out_dim // 2."""

    def __init__(self, block_name, in_dim, out_dim, radius, layer_ind, cfg):
        super().__init__(block_name, layer_ind, cfg)
        self.KPConv = _kpconv_layer(cfg, block_name, in_dim, out_dim // 2, radius)
        self.bn = MaskedBatchNorm(out_dim // 2, cfg.use_batch_norm,
                                  momentum=cfg.batch_norm_momentum)

    def _forward(self, x, pyr, infl=None):
        q, inds, out_mask, key = _conv_site(self.block_name, self.layer_ind, pyr)
        pi = infl.get(key) if infl is not None else None
        x = self.KPConv(q, pyr.points[self.layer_ind], inds, x, pi, out_mask)
        return F.leaky_relu(self.bn(x, out_mask), 0.1)


class ResnetBottleneckBlock(_ConvBlock):
    """unary↓4 → KPConv → unary↑ (+ max-pooled shortcut on strided blocks)."""

    def __init__(self, block_name, in_dim, out_dim, radius, layer_ind, cfg):
        super().__init__(block_name, layer_ind, cfg)
        mid = out_dim // 4
        bn, mo = cfg.use_batch_norm, cfg.batch_norm_momentum
        self.unary1 = UnaryBlock(in_dim, mid, bn, bn_momentum=mo) if in_dim != mid else None
        self.KPConv = _kpconv_layer(cfg, block_name, mid, mid, radius)
        self.bn_conv = MaskedBatchNorm(mid, bn, momentum=mo)
        self.unary2 = UnaryBlock(mid, out_dim, bn, no_relu=True, bn_momentum=mo)
        self.unary_shortcut = (
            UnaryBlock(in_dim, out_dim, bn, no_relu=True, bn_momentum=mo)
            if in_dim != out_dim else None
        )

    def _forward(self, x, pyr, infl=None):
        l = self.layer_ind
        q, inds, out_mask, key = _conv_site(self.block_name, l, pyr)
        pi = infl.get(key) if infl is not None else None
        h = x if self.unary1 is None else self.unary1(x, pyr.masks[l])
        h = self.KPConv(q, pyr.points[l], inds, h, pi, out_mask)
        h = F.leaky_relu(self.bn_conv(h, out_mask), 0.1)
        h = self.unary2(h, out_mask)
        shortcut = max_pool(x, inds) if "strided" in self.block_name else x
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, out_mask)
        return F.leaky_relu(h + shortcut, 0.1)


class NearestUpsampleBlock(nn.Module):
    """Copy features from the closest coarser point."""

    def __init__(self, layer_ind: int):
        super().__init__()
        self.layer_ind = layer_ind  # level being upsampled TO is layer_ind - 1

    def forward(self, x, pyr):
        return closest_pool(x, pyr.upsamples[self.layer_ind - 1])


class MaxPoolBlock(nn.Module):
    def __init__(self, layer_ind: int):
        super().__init__()
        self.layer_ind = layer_ind

    def forward(self, x, pyr):
        return max_pool(x, pyr.pools[self.layer_ind + 1])


class GlobalAverageBlock(nn.Module):
    """Masked mean over the coarsest level → (B, C)."""

    def forward(self, x, pyr):
        m = pyr.masks[-1].to(x.dtype)[..., None]
        return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)


def block_decider(block_name: str, radius: float, in_dim: int, out_dim: int,
                  layer_ind: int, cfg) -> nn.Module:
    """Instantiate a block by architecture-list name."""
    if block_name == "unary":
        return UnaryBlock(in_dim, out_dim, cfg.use_batch_norm, bn_momentum=cfg.batch_norm_momentum)
    if block_name in ("simple", "simple_deformable", "simple_strided", "simple_deformable_strided"):
        return SimpleBlock(block_name, in_dim, out_dim, radius, layer_ind, cfg)
    if block_name in ("resnetb", "resnetb_deformable", "resnetb_strided", "resnetb_deformable_strided"):
        return ResnetBottleneckBlock(block_name, in_dim, out_dim, radius, layer_ind, cfg)
    if block_name == "nearest_upsample":
        return NearestUpsampleBlock(layer_ind)
    if block_name in ("max_pool", "max_pool_wide"):
        return MaxPoolBlock(layer_ind)
    if block_name == "global_average":
        return GlobalAverageBlock()
    raise ValueError(f"unknown block name in architecture: {block_name!r}")
