"""The reference MVPNet: a frozen UNet-ResNet34 over the views, each point's
3 nearest pixels, FeatureAggregation, then PointNet++ SSG, in plain PyTorch
on a flat dict of weights named as the port names its ``state_dict``.

Sources: Jaritz et al., "Multi-view PointNet for 3D Scene Understanding"
(ICCV Workshops 2019); maxjaritz/mvpnet ``mvpnet/models/mvpnet_3d.py``
(the UNet's 64 feature channels, the 3 nearest pixels, FeatureAggregation
64 → 64, 64, 64 summed over the pixels, then PN2SSG) and
``mvpnet/models/pn2/pn2ssg.py`` (four set abstractions: farthest point
sampling, a ball query of the first 32 hits in index order, a shared MLP on
the neighbours' features ⊕ their position relative to the centroid, a max
over the neighbours; four feature propagations: 3-NN inverse-distance
interpolation, the skip's features concatenated after, a shared MLP; the
segmentation MLP and a biased logit layer). A shared MLP layer is a dense
product without bias, batch norm, ReLU (the published 1×1 convolutions
without bias before a batch norm). Every point of a chunk is real: no mask.

Reused as they are from ``portbench/reference``: the UNet (``unet.py``),
the unprojection and the projective pixel association (``geometry.py``,
with the window of 9 pixels the configuration gives) and the
FeatureAggregation equations (``model.Reference.lift``), so the lift is the
one MV-KPConv's cells hold their port to.

The geometry, as the published CUDA ops compute it, each step of f32
arithmetic rounded on its own:

  * farthest point sampling: the first centroid index 0, each next the
    largest least squared distance to the chosen ones, ties to the lower
    index (``torch.argmax``), d² in the difference form
    ((dx² + dy²) + dz²);
  * ball query: the supports with d² < r², d² in the difference form and r²
    the f32 square of the f32 radius, the first 32 in index order, a short
    row's empty slots filled with its first hit;
  * three nearest neighbours: ascending by (difference-form d², index);
    weights 1 / max(d², 1e-10), normalised by their sum.

The port computes these the same way. The JAX package's expansion form
‖q‖² − 2 q·s + ‖s‖², whose error grows with ‖q‖², would part them at
rooms' coordinates of up to 6 m: supports moved across the first ball's
radius and 3-NN weights moved, 0.11 in ``logits_err`` on a CPU batch of
the cell's size. No departure is known.

Batch norm of rows is ``(x − mean)·(rsqrt(var + eps)·w) + b``, the scale
folded first, as ``portbench/reference/unet.py``'s 2D batch norm and the
port compute it (``Reference.bn_rows`` of ``portbench/reference`` folds it
last: one rounding apart, which a calibrated PointNet++ grows to ~2e-5 of
the logits).

``mode``: ``eval`` (running statistics) or ``calibrate`` (every batch norm,
the UNet's too, takes its batch's statistics over every row it normalises
and writes them into the weights as its running ones).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import unet
from portbench.reference.model import EPS, float32_exact
from portbench.reference.model import Reference as Lift

INTERP_EPS = 1e-10  # the floor on a 3-NN's d² (mvpnet/models/pn2/modules.py)
Weights = Dict[str, torch.Tensor]


def widths(model: Dict) -> Tuple[List[int], List[int]]:
    """(each set abstraction's input width, each feature propagation's),
    from the dataflow: the relative xyz appended to a level's features; the
    sparse features ⊕ the skip's, the input's left out of the skips."""
    feats = [model["aggregation_channels"][-1]]
    sa_in = []
    for channels in model["sa_channels"]:
        sa_in.append(feats[-1] + 3)
        feats.append(channels[-1])
    skips = [0] + feats[1:]
    fp_in, x = [], feats[-1]
    for i, channels in enumerate(model["fp_channels"]):
        fp_in.append(x + skips[-2 - i])
        x = channels[-1]
    return sa_in, fp_in


def _mlp(prefix: str, cin: int, channels) -> List[Tuple[str, tuple, str]]:
    out = []
    for j, c in enumerate(channels):
        out += [(f"{prefix}.dense{j}.weight", (c, cin), "linear"), (f"{prefix}.bn{j}", (c,), "bn")]
        cin = c
    return out


def spec(model: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every weight and statistic; a ``bn`` entry
    stands for its weight, bias, running mean and running variance."""
    out = [(f"net_2d.{n}", s, k) for n, s, k in unet.spec(model["num_classes"])]
    out += _mlp("feat_aggreg.mlp", model["feature_2d_dim"] + 4, model["aggregation_channels"])
    sa_in, fp_in = widths(model)
    for i, (cin, channels) in enumerate(zip(sa_in, model["sa_channels"])):
        out += _mlp(f"net_3d.sa{i}.mlp", cin, channels)
    for i, (cin, channels) in enumerate(zip(fp_in, model["fp_channels"])):
        out += _mlp(f"net_3d.fp{i}.mlp", cin, channels)
    out += _mlp("net_3d.mlp_seg", model["fp_channels"][-1][-1], model["seg_channels"])
    out += [("net_3d.seg_logit.weight", (model["num_classes"], model["seg_channels"][-1]), "linear"),
            ("net_3d.seg_logit.bias", (model["num_classes"],), "bias")]
    return out


def tensors(model: Dict) -> List[Tuple[str, tuple, str]]:
    """:func:`spec` with each batch norm split into its tensors: (name,
    shape, kind) of the kinds ``weights.draw`` knows."""
    out = []
    for name, shape, kind in spec(model):
        if kind == "bn":
            out += [(f"{name}.weight", shape, "bn_weight"), (f"{name}.bias", shape, "bias"),
                    (f"{name}.running_mean", shape, "running_mean"), (f"{name}.running_var", shape, "running_var")]
        else:
            out.append((name, shape, kind))
    return out


# ----- geometry, one chunk at a time -----

def diff_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) × (..., 3) → (dx² + dy²) + dz², f32."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def farthest_points(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """(B, N, 3) → (B, m) int64 indices of the iterative FPS."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    out = torch.zeros((b, m), dtype=torch.int64, device=xyz.device)
    least = torch.full((b, n), float("inf"), device=xyz.device)
    for i in range(1, m):
        least = torch.minimum(least, diff_sq(xyz, xyz[rows, out[:, i - 1]][:, None, :]))
        out[:, i] = torch.argmax(least, dim=1)
    return out


def ball_query(centroids: torch.Tensor, support: torch.Tensor, radius: float, k: int) -> torch.Tensor:
    """(M, 3) centroids, (N, 3) supports → (M, k) int64: the first ``k``
    supports inside the radius in index order, empty slots the first hit."""
    r = np.float32(radius)
    r2 = torch.tensor(float(r * r), dtype=torch.float32, device=support.device)
    hit = diff_sq(centroids[:, None, :], support[None, :, :]) < r2
    rank = torch.cumsum(hit.to(torch.int64), dim=1)  # hits so far, at each support
    take = hit & (rank <= k)
    m = len(centroids)
    out = torch.zeros((m, k + 1), dtype=torch.int64, device=support.device)
    slot = torch.where(take, rank - 1, torch.full_like(rank, k))  # slot k: the discard
    out.scatter_(1, slot, torch.arange(support.shape[0], device=support.device).expand(m, -1))
    out = out[:, :k]
    found = torch.clamp(rank[:, -1], max=k)
    if bool((found == 0).any()):
        raise ValueError("a centroid with no support inside its radius")
    slots = torch.arange(k, device=support.device)
    return torch.where(slots[None, :] < found[:, None], out, out[:, :1])


def three_nn(query: torch.Tensor, key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, 3) queries, (K, 3) keys → ((Q, 3) int64 indices, (Q, 3) d²),
    ascending by (d², index)."""
    d2 = diff_sq(query[:, None, :], key[None, :, :])
    order = (d2.view(torch.int32).to(torch.int64) << 32) | torch.arange(len(key), device=key.device)
    idx = torch.topk(order, 3, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
    return idx, torch.gather(d2, 1, idx)


class Reference(Lift):
    """One forward of the reference over a chunk batch: points (B, N, 3),
    images (B, V, H, W, 3), depth (B, V, H, W), intrinsics, poses."""

    def bn_rows(self, name: str, x: torch.Tensor, fast_var: bool = False) -> torch.Tensor:
        """Batch norm of (..., C) rows over every row, the scale folded
        first; the lift's FeatureAggregation takes it too."""
        mean, var = self._stats(name, x, tuple(range(x.dim() - 1)), fast_var)
        return (x - mean) * (torch.rsqrt(var + EPS) * self.w[f"{name}.weight"]) + self.w[f"{name}.bias"]

    def mlp(self, prefix: str, x: torch.Tensor, layers: int) -> torch.Tensor:
        for j in range(layers):
            x = x @ self.w[f"{prefix}.dense{j}.weight"].t()
            x = F.relu(self.bn_rows(f"{prefix}.bn{j}", x, fast_var=True))
        return x

    def set_abstraction(self, i: int, xyz: torch.Tensor, feat: torch.Tensor):
        m = self.model
        centroids = farthest_points(xyz, m["num_centroids"][i])
        new_xyz = torch.stack([p[c] for p, c in zip(xyz, centroids)])
        idx = torch.stack([ball_query(q, p, m["radii"][i], m["max_neighbors"]) for q, p in zip(new_xyz, xyz)])
        rel = torch.stack([p[j] for p, j in zip(xyz, idx)]) - new_xyz[:, :, None, :]
        grouped = torch.cat([torch.stack([f[j] for f, j in zip(feat, idx)]), rel], dim=-1)
        out = self.mlp(f"net_3d.sa{i}.mlp", grouped, len(m["sa_channels"][i]))
        return new_xyz, out.amax(dim=2)

    def feature_propagation(self, i: int, dense_xyz, sparse_xyz, dense_feat, sparse_feat):
        rows = []
        for q, k, f in zip(dense_xyz, sparse_xyz, sparse_feat):
            idx, d2 = three_nn(q, k)
            inv = 1.0 / torch.clamp(d2, min=INTERP_EPS)
            weight = inv / inv.sum(dim=1, keepdim=True)
            rows.append((f[idx] * weight[..., None]).sum(dim=1))
        x = torch.stack(rows)
        if dense_feat is not None:
            x = torch.cat([x, dense_feat], dim=-1)
        return self.mlp(f"net_3d.fp{i}.mlp", x, len(self.model["fp_channels"][i]))

    def __call__(self, batch: Dict[str, torch.Tensor]):
        """(logits (B·N, C), lengths: N for each chunk)."""
        m = self.model
        xyz = batch["points"].float()
        b, n, _ = xyz.shape
        lengths = [n] * b
        feat = self.lift(batch, xyz.reshape(b * n, 3), lengths).reshape(b, n, -1)
        xyzs, feats = [xyz], [None]
        for i in range(len(m["sa_channels"])):
            xyz, feat = self.set_abstraction(i, xyz, feat)
            xyzs.append(xyz)
            feats.append(feat)
        for i in range(len(m["fp_channels"])):
            feat = self.feature_propagation(i, xyzs[-2 - i], xyzs[-1 - i], feats[-2 - i], feat)
        x = self.mlp("net_3d.mlp_seg", feat, len(m["seg_channels"]))
        out = x @ self.w["net_3d.seg_logit.weight"].t() + self.w["net_3d.seg_logit.bias"]
        return out.reshape(b * n, -1), lengths


@torch.no_grad()
def calibrate(model: Dict, weights: Weights, batch: Dict[str, torch.Tensor]) -> None:
    """Every batch norm's running statistics set, in place, to its batch
    statistics over ``batch``."""
    with float32_exact():
        Reference(model, weights, "calibrate")(batch)


@torch.no_grad()
def logits(model: Dict, weights: Weights, batch: Dict[str, torch.Tensor]):
    """(logits (B·N, C) of every point, lengths) in eval mode, float32 with
    TF32 off."""
    with float32_exact():
        return Reference(model, weights, "eval")(batch)
