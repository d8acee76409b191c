"""The reference MV-KPConv (early and middle fusion) and KPConv baseline: plain
PyTorch on stacked real points, with weights in a flat dict named as the
port names its ``state_dict``.

It follows KPConv-PyTorch's ``KPFCNN`` (architectures.py:189-394) and the
MV-KPConv fusion scripts: rigid KPConv with linear influence and sum
aggregation, the ``simple`` / ``resnetb`` / ``resnetb_strided`` /
``nearest_upsample`` / ``unary`` blocks, batch norm over the real points of a
level, leaky ReLU 0.1, skip concatenation after each upsample, and a head
of two unary layers with biases (leaky ReLU on the logits too). The 2D branch: unprojection, the projective pixel k-NN,
UNet-ResNet34 (frozen: running statistics), and the ContFuse aggregation (a
shared MLP on each pixel's features ⊕ [Δxyz, |Δxyz|²], batch norm over the
real points' pixel rows, summed over the k pixels). Middle fusion runs two
encoders (3D on the base columns, 2D on ones ⊕ the lifted features),
averages their bottlenecks and concatenates their skips.

``mode``: ``eval`` (running statistics) or ``calibrate`` (every batch
norm, the UNet's too, takes its batch's statistics and writes them into the
weights as its running ones).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import unet
from portbench.reference.dispositions import kernel_points
from portbench.reference.geometry import build_pyramid, pixel_neighbors, unproject

EPS = 1e-5
Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def float32_exact():
    """TF32 off in matmuls and cuDNN for the reference's own computation;
    the process's settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def plan(model: Dict, in_dim: int):
    """(encoder, decoder, skip widths) of the architecture list: encoder
    entries (block, in, out, radius, level), decoder entries (block, in, out,
    radius, level, concat) — KPFCNN's scan of ``config.architecture``."""
    arch = list(model["architecture"])
    layer, r, out_dim = 0, model["first_subsampling_dl"] * model["conv_radius"], model["first_features_dim"]
    enc, skips, start = [], [], len(arch)
    for i, blk in enumerate(arch):
        if any(t in blk for t in ("pool", "strided", "upsample", "global")):
            skips.append(in_dim)
        if "upsample" in blk:
            start = i
            break
        enc.append((blk, in_dim, out_dim, r, layer))
        in_dim = out_dim // 2 if "simple" in blk else out_dim
        if "strided" in blk:
            layer, r, out_dim = layer + 1, r * 2, out_dim * 2
    dec = []
    for j, blk in enumerate(arch[start:]):
        concat = j > 0 and "upsample" in arch[start + j - 1]
        if concat:
            in_dim += skips[layer]
        dec.append((blk, in_dim, out_dim, r, layer, concat))
        in_dim = in_dim if "upsample" in blk else out_dim
        if "upsample" in blk:
            layer, r, out_dim = layer - 1, r * 0.5, out_dim // 2
    return enc, dec, skips


def base_dim(model: Dict) -> int:
    return model["in_features_dim"] - (model["feature_2d_dim"] if model["fusion"] != "none" else 0)


def trunk(model: Dict):
    """{encoder name: plan}, decoder plan, head input width."""
    if model["fusion"] == "middle":
        enc3, dec, _ = plan(model, base_dim(model))
        enc2, _, skips2 = plan(model, model["feature_2d_dim"] + 1)
        dec = [(b, i + (skips2[lv] if c else 0), o, r, lv, c) for b, i, o, r, lv, c in dec]
        encoders = {"encoder_3d": enc3, "encoder_2d": enc2}
    else:
        enc, dec, _ = plan(model, model["in_features_dim"] if model["fusion"] == "early" else base_dim(model))
        encoders = {"encoder": enc}
    return encoders, dec, dec[-1][2]


def _block_spec(prefix: str, blk: str, cin: int, cout: int, m: int) -> List[Tuple[str, tuple, str]]:
    def unary(p, i, o, bn=True):
        return [(f"{p}.mlp.weight", (o, i), "linear"), (f"{p}.bn", (o,), "bn" if bn else "bias_only")]

    if blk == "unary":
        return unary(prefix, cin, cout)
    if blk == "simple":
        return [(f"{prefix}.KPConv.weights", (m, cin, cout // 2), "kpconv"), (f"{prefix}.bn", (cout // 2,), "bn")]
    if blk in ("resnetb", "resnetb_strided"):
        mid = cout // 4
        out = unary(f"{prefix}.unary1", cin, mid) if cin != mid else []
        out += [(f"{prefix}.KPConv.weights", (m, mid, mid), "kpconv"), (f"{prefix}.bn_conv", (mid,), "bn")]
        out += unary(f"{prefix}.unary2", mid, cout)
        if cin != cout:
            out += unary(f"{prefix}.unary_shortcut", cin, cout)
        return out
    if blk == "nearest_upsample":
        return []
    raise ValueError(f"the reference has no block {blk!r}")


def spec(model: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every weight and statistic of the model; a
    ``bn`` entry stands for its ``weight``, ``bias``, ``running_mean`` and
    ``running_var``, a ``bias_only`` one for its ``bias``."""
    m = model["num_kernel_points"]
    out = []
    if model["fusion"] != "none":
        out += [(f"net_2d.{n}", s, k) for n, s, k in unet.spec(model["num_classes"])]
        cin = model["feature_2d_dim"] + 4
        for i in range(3):
            out += [(f"feat_aggreg.mlp.dense{i}.weight", (64, cin), "linear"), (f"feat_aggreg.mlp.bn{i}", (64,), "bn")]
            cin = 64
    encoders, dec, head_in = trunk(model)
    for name, enc in encoders.items():
        for i, (blk, cin, cout, _r, _l) in enumerate(enc):
            out += _block_spec(f"{name}.block_{i}", blk, cin, cout, m)
    for i, (blk, cin, cout, _r, _l, _c) in enumerate(dec):
        out += _block_spec(f"decoder.block_{i}", blk, cin, cout, m)
    f = model["first_features_dim"]
    out += [("head.head_mlp.mlp.weight", (f, head_in), "linear"), ("head.head_mlp.bn", (f,), "bias_only"),
            ("head.head_softmax.mlp.weight", (model["num_classes"], f), "linear"),
            ("head.head_softmax.bn", (model["num_classes"],), "bias_only")]
    return out


def tensors(model: Dict) -> List[Tuple[str, tuple, str]]:
    """:func:`spec` with each batch norm split into its tensors: (name,
    shape, kind), kind one of conv, deconv, linear, kpconv, bias, bn_weight,
    running_mean, running_var."""
    out = []
    for name, shape, kind in spec(model):
        if kind == "bn":
            out += [(f"{name}.weight", shape, "bn_weight"), (f"{name}.bias", shape, "bias"),
                    (f"{name}.running_mean", shape, "running_mean"), (f"{name}.running_var", shape, "running_var")]
        elif kind == "bias_only":
            out.append((f"{name}.bias", shape, "bias"))
        else:
            out.append((name, shape, kind))
    return out


class Reference:
    """One forward of the reference over a padded batch (the benchmark's
    host layout: real points first in each sphere, ``mask`` marking them)."""

    def __init__(self, model: Dict, weights: Weights, mode: str):
        if mode not in ("eval", "calibrate"):
            raise ValueError(mode)
        self.model, self.w, self.mode = model, weights, mode
        self._kp = {}

    # ----- normalisation -----
    def _stats(self, name: str, x: torch.Tensor, dims, fast_var: bool):
        if self.mode == "eval":
            return self.w[f"{name}.running_mean"], self.w[f"{name}.running_var"]
        mean = x.mean(dims)
        var = (x * x).mean(dims) - mean * mean if fast_var else ((x - mean.reshape(
            [-1 if d not in dims else 1 for d in range(x.dim())])) ** 2).mean(dims)
        var = var.clamp(min=0.0)
        if self.mode == "calibrate":
            self.w[f"{name}.running_mean"] = mean.detach().clone()
            self.w[f"{name}.running_var"] = var.detach().clone()
        return mean, var

    def bn_rows(self, name: str, x: torch.Tensor, fast_var: bool = False) -> torch.Tensor:
        """Batch norm of (..., C) rows over every row."""
        mean, var = self._stats(name, x, tuple(range(x.dim() - 1)), fast_var)
        return (x - mean) * torch.rsqrt(var + EPS) * self.w[f"{name}.weight"] + self.w[f"{name}.bias"]

    def bn_2d(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The UNet's batch norm of (N, C, H, W); frozen: its running
        statistics unless calibrating."""
        if self.mode == "calibrate":
            mean, var = self._stats(name, x, (0, 2, 3), fast_var=True)
        else:
            mean, var = self.w[f"{name}.running_mean"], self.w[f"{name}.running_var"]
        scale = torch.rsqrt(var + EPS) * self.w[f"{name}.weight"]
        return (x - mean[:, None, None]) * scale[:, None, None] + self.w[f"{name}.bias"][:, None, None]

    # ----- KPConv -----
    def kernel_points(self, r: float, device) -> torch.Tensor:
        key = (r, device)
        if key not in self._kp:
            self._kp[key] = torch.from_numpy(kernel_points(r, self.model["num_kernel_points"])).to(device)
        return self._kp[key]

    def influence(self, q_pts, s_pts, nbr, r):
        """(Nq, K, M) linear influence of each real neighbor on each kernel
        point, 0 at empty slots."""
        valid = nbr < len(s_pts)
        safe = torch.where(valid, nbr, torch.zeros_like(nbr))
        rel = s_pts[safe] - q_pts[:, None, :]
        d2 = ((rel[:, :, None, :] - self.kernel_points(r, q_pts.device)) ** 2).sum(-1)
        extent = r * self.model["kp_extent"] / self.model["conv_radius"]
        h = (1.0 - torch.sqrt(d2) / extent).clamp(min=0.0)
        return h * valid[..., None]

    @staticmethod
    def gather(x, nbr):
        """Rows of x at (Nq, K) indices, zeros at empty slots (index len(x))."""
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[nbr]

    def kpconv(self, name, x, site):
        h, nbr = site
        wts = self.w[f"{name}.KPConv.weights"]
        m, cin, cout = wts.shape
        wf = torch.einsum("qkm,qkc->qmc", h, self.gather(x, nbr))
        return wf.reshape(len(wf), m * cin) @ wts.reshape(m * cin, cout)

    def unary(self, name, x, relu=True, bn=True):
        y = x @ self.w[f"{name}.mlp.weight"].t()
        y = self.bn_rows(f"{name}.bn", y) if bn else y + self.w[f"{name}.bn.bias"]
        return F.leaky_relu(y, 0.1) if relu else y

    def block(self, prefix, entry, x, pyr, sites):
        blk, cin, cout = entry[:3]
        layer = entry[4]
        if blk == "unary":
            return self.unary(prefix, x)
        if blk == "nearest_upsample":
            return self.gather(x, pyr[layer - 1].up)[:, 0]
        site = sites[("pool" if "strided" in blk else "conv", layer)]
        if blk == "simple":
            return F.leaky_relu(self.bn_rows(f"{prefix}.bn", self.kpconv(prefix, x, site)), 0.1)
        mid = cout // 4
        h = x if cin == mid else self.unary(f"{prefix}.unary1", x)
        h = F.leaky_relu(self.bn_rows(f"{prefix}.bn_conv", self.kpconv(prefix, h, site)), 0.1)
        h = self.unary(f"{prefix}.unary2", h, relu=False)
        shortcut = self.gather(x, site[1]).amax(dim=1) if "strided" in blk else x
        if cin != cout:
            shortcut = self.unary(f"{prefix}.unary_shortcut", shortcut, relu=False)
        return F.leaky_relu(h + shortcut, 0.1)

    # ----- the model -----
    def lift(self, batch, pts0, lengths):
        """(ΣN, 64) lifted 2D features of the real points."""
        m = self.model
        b, v, h, w, _ = batch["images"].shape
        image_xyz = unproject(batch["depth"], batch["intrinsics"], batch["poses"])
        idx = []
        offs = np.cumsum([0] + lengths)
        for i in range(b):
            pix = pixel_neighbors(pts0[offs[i]:offs[i + 1]], image_xyz[i], batch["intrinsics"][i],
                                  batch["poses"][i], m["pixel_knn"], m["pixel_window"])
            idx.append(pix + i * v * h * w)
        idx = torch.cat(idx)
        feat = unet.features(batch["images"].reshape(b * v, h, w, 3),
                             {k[7:]: t for k, t in self.w.items() if k.startswith("net_2d.")},
                             lambda n, x: self.bn_2d(f"net_2d.{n}", x))
        src_xyz = image_xyz.reshape(-1, 3)[idx]
        src_feat = feat.reshape(b * v * h * w, -1)[idx]
        diff = src_xyz - pts0[:, None, :]
        x = torch.cat([src_feat, diff, (diff * diff).sum(-1, keepdim=True)], dim=-1)
        for i in range(3):
            x = x @ self.w[f"feat_aggreg.mlp.dense{i}.weight"].t()
            x = F.relu(self.bn_rows(f"feat_aggreg.mlp.bn{i}", x, fast_var=True))
        return x.sum(dim=1)

    def __call__(self, batch: Dict[str, torch.Tensor]):
        """(logits (ΣN, C) of the real points, labels (ΣN,), lengths)."""
        m = self.model
        lengths = [int(n) for n in batch["mask"].sum(1).tolist()]
        pts = [batch["points"][i, :n] for i, n in enumerate(lengths)]
        pyr = build_pyramid(pts, m)
        pts0 = pyr[0].points
        base = torch.cat([batch["features"][i, :n] for i, n in enumerate(lengths)])
        labels = torch.cat([batch["labels"][i, :n] for i, n in enumerate(lengths)])
        encoders, dec, _ = trunk(m)
        sites = {}
        for enc in list(encoders.values()) + [dec]:
            for blk, _i, _o, r, lv, *_ in enc:
                if "simple" in blk or "resnetb" in blk:
                    kind = "pool" if "strided" in blk else "conv"
                    if (kind, lv) not in sites:
                        q = pyr[lv + 1].points if kind == "pool" else pyr[lv].points
                        nbr = pyr[lv].pool if kind == "pool" else pyr[lv].conv
                        sites[(kind, lv)] = (self.influence(q, pyr[lv].points, nbr, r), nbr)

        def encode(name, x):
            skips = []
            for i, entry in enumerate(encoders[name]):
                if "strided" in entry[0]:
                    skips.append(x)
                x = self.block(f"{name}.block_{i}", entry, x, pyr, sites)
            return x, skips

        if m["fusion"] == "none":
            x, skips = encode("encoder", base)
        else:
            lifted = self.lift(batch, pts0, lengths)
            if m["fusion"] == "early":
                x, skips = encode("encoder", torch.cat([base, lifted], dim=-1))
            else:
                x3, s3 = encode("encoder_3d", base)
                x2, s2 = encode("encoder_2d", torch.cat([torch.ones_like(lifted[:, :1]), lifted], dim=-1))
                x, skips = 0.5 * (x3 + x2), [torch.cat([a, b], dim=-1) for a, b in zip(s3, s2)]
        for i, entry in enumerate(dec):
            if entry[5]:
                x = torch.cat([x, skips.pop()], dim=-1)
            x = self.block(f"decoder.block_{i}", entry, x, pyr, sites)
        x = self.unary("head.head_mlp", x, bn=False)
        return self.unary("head.head_softmax", x, bn=False), labels, lengths


@torch.no_grad()
def calibrate(model: Dict, weights: Weights, batch: Dict[str, torch.Tensor]) -> None:
    """Every batch norm's running statistics set, in place, to its batch
    statistics over ``batch``."""
    with float32_exact():
        Reference(model, weights, "calibrate")(batch)


@torch.no_grad()
def logits(model: Dict, weights: Weights, batch: Dict[str, torch.Tensor]):
    """(logits (ΣN, C) of the real points, lengths) in eval mode, float32 with
    TF32 off."""
    with float32_exact():
        out, _, lengths = Reference(model, weights, "eval")(batch)
    return out, lengths
