"""Deformable-kernel inspection artifacts (``mvkpconv_tpu/eval/deform_inspect.py``).

The headless counterpart of the reference's mayavi deformed-kernel
inspector (KPConv-PyTorch/utils/visualizer.py ``ModelVisualizer``): the
deformed kernel points and fitting distances of one forward, put back in
world space, written as one PLY (and one viewer HTML) per deformable layer
(the query level's cloud and, for a strided subset of its valid queries,
the M deformed kernel points, coloured by kernel point, with the fitting
distance as a scalar field) and as per-layer statistics (offset
magnitudes, the share of kernel points within the extent of a real
neighbour) in ``deform_stats.json``.

Where the JAX package sows ``deform_kp_locs`` / ``deform_min_d2`` into the
``intermediates`` collection, the port reads each deformable
``KPConvLayer``'s ``deform_aux`` (``models/blocks.py``), which its last
forward left: (min d² / extent², moved kernel points / extent relative to
their query, query mask), the sown values. Layers are named by their
block's module path with '/' ("encoder/block_3[resnetb_deformable]"), the
flax scope the JAX package names them by.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from mvkpconv_tpu_torch.utils.ply import write_ply

# distinct colors per kernel point (cycled when M > len)
_KP_PALETTE = np.asarray(
    [
        (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
        (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
        (210, 245, 60), (250, 190, 212), (0, 128, 128), (220, 190, 255),
        (170, 110, 40), (255, 250, 200), (128, 0, 0),
    ],
    np.uint8,
)


def deformable_plan_entries(cfg) -> List[tuple]:
    """(block_name, radius, layer_ind) for each deformable conv block, in
    execution order."""
    from mvkpconv_tpu_torch.models.kpfcnn import plan_architecture

    enc, dec, _ = plan_architecture(cfg)
    return [(name, r, layer) for (name, _i, _o, r, layer, _c) in list(enc) + list(dec)
            if "deform" in name]


def deform_layers(model: torch.nn.Module) -> List[tuple]:
    """(module path, layer) of every deformable ``KPConvLayer``, in the
    order of the model's blocks."""
    from mvkpconv_tpu_torch.models.blocks import KPConvLayer

    return [(name, mod) for name, mod in model.named_modules()
            if isinstance(mod, KPConvLayer) and mod.deformable]


def collect_deform_layers(model: torch.nn.Module, cfg, pyr) -> List[Dict]:
    """Pair each deformable layer's ``deform_aux`` with the plan's geometry.

    Returns one dict per deformable conv layer: name, level, extent (world
    units), q_pts (B, Nq, 3), q_mask (B, Nq), kp_world (B, Nq, M, 3)
    absolute deformed kernel positions, min_d2_norm (B, Nq, M) fitting
    distances / extent². Raises where a layer has no ``deform_aux`` (no
    forward ran) or the model's layers do not match the plan's."""
    entries = deformable_plan_entries(cfg)
    layers = deform_layers(model)
    if len(layers) != len(entries) or any(m.deform_aux is None for _, m in layers):
        raise ValueError(
            f"found {sum(m.deform_aux is not None for _, m in layers)} deformable layers with "
            f"deform_aux but the plan has {len(entries)}: run a forward of this model first"
        )
    out = []
    for (path, mod), (name, radius, layer) in zip(layers, entries):
        min_d2, locs, _ = mod.deform_aux
        extent = radius * cfg.kp_extent / cfg.conv_radius
        q_level = layer + 1 if "strided" in name else layer
        q_pts = pyr.points[q_level].detach().float().cpu().numpy()
        q_mask = pyr.masks[q_level].detach().cpu().numpy()
        kp_world = q_pts[:, :, None, :] + locs.detach().float().cpu().numpy() * extent
        block = path.replace(".", "/").rsplit("/", 1)[0]
        out.append(dict(
            name=f"{block}[{name}]",
            level=q_level,
            extent=float(extent),
            q_pts=q_pts,
            q_mask=q_mask,
            kp_world=kp_world.astype(np.float32),
            min_d2_norm=min_d2.detach().float().cpu().numpy(),
        ))
    return out


def deform_stats(layers: List[Dict]) -> List[Dict]:
    """Per-layer health numbers: mean and max distance of the deformed
    kernel points from their query in extents, and the share of them
    within extent of a real neighbour (min_d2_norm < 1)."""
    stats = []
    for lay in layers:
        m = lay["q_mask"]
        rel = (lay["kp_world"] - lay["q_pts"][:, :, None, :]) / lay["extent"]
        mag = np.linalg.norm(rel, axis=-1)[m]
        fit = (lay["min_d2_norm"] < 1.0)[m]
        stats.append(dict(
            name=lay["name"],
            level=lay["level"],
            extent=lay["extent"],
            mean_kp_radius=float(mag.mean()) if mag.size else 0.0,
            max_kp_radius=float(mag.max()) if mag.size else 0.0,
            fit_fraction=float(fit.mean()) if fit.size else 0.0,
        ))
    return stats


def dump_deform_plys(out_dir, layers: List[Dict], batch_index: int = 0,
                     max_queries: int = 128) -> List[Path]:
    """One PLY (and viewer HTML) per deformable layer. Rows: the query
    level's cloud (kind=0, gray) ⊕ the M deformed kernel points of up to
    ``max_queries`` valid queries (kind=1, coloured by kernel point).
    Fields: x y z red green blue kind query_id kp_id min_d2 (the fitting
    distance / extent²: 1.0 separates kernel points on the geometry from
    lost ones)."""
    from mvkpconv_tpu_torch.utils.html_viewer import save_html_viewer

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for li, lay in enumerate(layers):
        b = batch_index
        pts = lay["q_pts"][b]
        mask = lay["q_mask"][b]
        valid = np.nonzero(mask)[0]
        sel = valid[:: max(1, len(valid) // max_queries)][:max_queries]
        m = lay["kp_world"].shape[2]

        cloud_xyz = pts[mask]
        cloud_rgb = np.full((len(cloud_xyz), 3), 160, np.uint8)
        kp_xyz = lay["kp_world"][b, sel].reshape(-1, 3)
        kp_rgb = np.tile(_KP_PALETTE[np.arange(m) % len(_KP_PALETTE)], (len(sel), 1))
        kp_d2 = lay["min_d2_norm"][b, sel].reshape(-1)

        xyz = np.concatenate([cloud_xyz, kp_xyz]).astype(np.float32)
        rgb = np.concatenate([cloud_rgb, kp_rgb])
        kind = np.concatenate([np.zeros(len(cloud_xyz), np.uint8), np.ones(len(kp_xyz), np.uint8)])
        qid = np.concatenate([np.full(len(cloud_xyz), -1, np.int32), np.repeat(sel.astype(np.int32), m)])
        kpid = np.concatenate([np.full(len(cloud_xyz), -1, np.int32),
                               np.tile(np.arange(m, dtype=np.int32), len(sel))])
        d2 = np.concatenate([np.zeros(len(cloud_xyz), np.float32), kp_d2.astype(np.float32)])
        path = out_dir / f"deform_layer{li}_L{lay['level']}.ply"
        write_ply(path, [xyz, rgb, kind, qid, kpid, d2],
                  ["x", "y", "z", "red", "green", "blue", "kind", "query_id", "kp_id", "min_d2"])
        paths.append(path)

        lost = kp_d2 > 1.0
        save_html_viewer(
            out_dir / f"deform_layer{li}_L{lay['level']}.html",
            [
                {"name": "level cloud", "points": cloud_xyz, "colors": cloud_rgb},
                {"name": "deformed kernel points", "points": kp_xyz[~lost],
                 "colors": kp_rgb[~lost], "size": 2.0},
                {"name": "lost kernel points (min_d2 > 1)", "points": kp_xyz[lost],
                 "colors": kp_rgb[lost], "size": 2.0},
            ],
            title=f"deformable layer {li} (level {lay['level']})",
        )
    return paths


@torch.no_grad()
def inspect_deformable(model: torch.nn.Module, batch: Dict[str, np.ndarray], cfg, out_dir,
                       batch_index: int = 0) -> Dict:
    """One forward of ``model`` (a KPFCNN or an MV-KPConv with deformable
    blocks) on the numpy ``batch``, on the model's device; writes the PLYs
    and ``deform_stats.json`` and returns the stats dict."""
    from mvkpconv_tpu_torch.infer import apply_model, batch_to_device, model_pyramid

    dev = next(model.parameters()).device
    tb = batch_to_device(batch, dev)
    for _, mod in deform_layers(model):
        mod.deform_aux = None
    was_training = model.training
    model.eval()
    try:
        pyr = model_pyramid(model, tb)
        apply_model(model, tb, pyr)
    finally:
        model.train(was_training)
    layers = collect_deform_layers(model, cfg, pyr)
    stats = deform_stats(layers)
    paths = dump_deform_plys(out_dir, layers, batch_index=batch_index)
    summary = {"layers": stats, "plys": [str(p) for p in paths]}
    (Path(out_dir) / "deform_stats.json").write_text(json.dumps(summary, indent=2))
    return summary
