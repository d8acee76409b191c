"""Precompute whole-scene lifted 2D features into a pickle cache
(``mvkpconv_tpu/tools/precompute_2d.py``; the reference's offline feature
dump, mvpnet/models/mvpnet_3d.py:346-406): each scene subsampled, its
frames through the trained UNet of a ``train_2d`` run (``model_best.pt``,
else the latest ``ckpt_*.pt``; or a JAX ``train_2d`` run's ``.msgpack``),
the points' lifted features attached as ``feature_2d3d``
(``eval/precompute.py``: kernel K2 per 4,096-point chunk), the frames
dropped. ``MVKPConv`` takes such scenes in place of its in-graph lift.

Runs on the first CUDA device unless ``--device`` names another.

Example:
  python -m mvkpconv_tpu_torch.tools.precompute_2d --run outputs/train2d \\
      --data synthetic:4 --out cache/features.pkl
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def main(argv=None):
    """Returns the scenes written."""
    ap = argparse.ArgumentParser(description=__doc__)
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes, resolve_config

    add_common_args(ap)
    ap.add_argument("--run", required=True, help="train_2d output dir")
    ap.add_argument("--out", required=True, help="output pickle path")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.eval.precompute import attach_precomputed_features
    from mvkpconv_tpu_torch.infer import resolve_device
    from mvkpconv_tpu_torch.models.feature_aggregation import FeatureAggregation
    from mvkpconv_tpu_torch.models.unet2d import UNetResNet34
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.init import init_parameters
    from mvkpconv_tpu_torch.training.transfer import load_2d_checkpoint

    device = resolve_device(args.device)
    run = Path(args.run)
    cfg = resolve_config(args, KPConfig.load(run / "parameters.txt"))
    scenes = load_scenes(args.data, True, max(cfg.num_views, 8), (cfg.image_height, cfg.image_width))
    unet = UNetResNet34(cfg.num_classes, dtype=cfg.compute_dtype).to(device)
    path = load_2d_checkpoint(unet, run)
    print(f"restored 2D UNet from {path}")
    # an untrained, seeded FeatureAggregation, as the reference's precompute
    # aggregates (mvpnet_3d.py:270)
    fa = init_parameters(FeatureAggregation(cfg.feature_2d_dim, dtype=cfg.compute_dtype).to(device), args.seed)
    cached = attach_precomputed_features(scenes, cfg, unet, fa)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("wb") as f:
        pickle.dump(cached, f)
    print(f"wrote {len(cached)} scenes with feature_2d3d "
          f"({cached[0]['feature_2d3d'].shape[1]}-d) to {out}")
    return cached


if __name__ == "__main__":
    main()
