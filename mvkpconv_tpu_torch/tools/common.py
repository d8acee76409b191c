"""Shared CLI plumbing (``mvkpconv_tpu/tools/common.py``): arguments, data
loading, config resolution."""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np


def add_common_args(ap: argparse.ArgumentParser):
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic[:N]' or path to a preprocessed split .pkl")
    ap.add_argument("--val-data", default=None,
                    help="validation split ('synthetic[:N]' or .pkl); "
                         "defaults to held-out synthetic scenes")
    ap.add_argument("--config", default=None, help="parameters.txt to load")
    ap.add_argument("--output", default="outputs/run", help="output directory")
    ap.add_argument("--steps", type=int, default=None, help="max train steps")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", action="store_true",
                    help="attach rendered multi-view RGB-D to synthetic scenes")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the first CUDA "
                         "device; raises on a host without one)")


def load_scenes(
    spec: str, with_views: bool, num_views: int, image_hw, seed_offset: int = 0
) -> List[Dict[str, np.ndarray]]:
    """'synthetic[-curved][:N]' → generated scenes; '<path>.pkl' →
    preprocessed split."""
    from mvkpconv_tpu_torch.data import synthetic
    from mvkpconv_tpu_torch.data.scannet_io import load_split

    if spec.startswith("synthetic"):
        n = int(spec.split(":")[1]) if ":" in spec else 4
        head = spec.split(":")[0]
        family = head.split("-", 1)[1] if "-" in head else "boxes"
        scenes = []
        for s in range(n):
            scene = synthetic.make_scene(
                seed=s + seed_offset, num_points=60000, family=family
            )
            if with_views:
                scene.update(
                    synthetic.render_views(
                        scene, max(num_views * 3, 8), image_hw[0], image_hw[1],
                        seed=s + seed_offset,
                    )
                )
            scenes.append(scene)
        return scenes
    return load_split(spec)


def resolve_config(args, base_cfg):
    from mvkpconv_tpu_torch.training.config import KPConfig

    cfg = KPConfig.load(args.config) if args.config else base_cfg
    if args.batch_size:
        cfg = cfg.replace(batch_num=args.batch_size)
    return cfg
