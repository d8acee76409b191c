"""Dump deformable-kernel inspection artifacts (PLYs + stats)
(``mvkpconv_tpu/tools/inspect_deform.py``).

Runs one forward of a deformable model on a sphere batch, collects each
deformable layer's deformed kernel points and fitting distances, and writes
per-layer PLYs (query cloud ⊕ deformed kernel points, coloured by kernel
point, with the normalized fitting distance as a scalar field) with a viewer
HTML each, and ``deform_stats.json`` (offset magnitudes, in-extent shares).

Runs on the first CUDA device unless ``--device`` names another
(``--device cpu`` runs every kernel's plain version).

Examples:
  # seeded weights, the deformable KPFCNN, on synthetic data
  python -m mvkpconv_tpu_torch.tools.inspect_deform --output outputs/deform

  # a trained run (the port's .pt or the JAX package's .msgpack checkpoints)
  python -m mvkpconv_tpu_torch.tools.inspect_deform --config run/parameters.txt \\
      --checkpoint run/checkpoints --output outputs/deform
"""

from __future__ import annotations

import argparse
import json

DEFORM_DEEPER = (
    "simple",
    "resnetb",
    "resnetb_strided",
    "resnetb_deformable",
    "resnetb_deformable",
    "resnetb_deformable_strided",
    "resnetb_deformable",
    "resnetb_deformable",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
)


def main(argv=None):
    """Returns the stats summary."""
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes, resolve_config

    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--checkpoint", default=None, help="checkpoint dir to restore the model from")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data.spheres import SphereDataset, device_batch
    from mvkpconv_tpu_torch.eval.deform_inspect import inspect_deformable
    from mvkpconv_tpu_torch.infer import make_model
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.jax_checkpoint import restore_run

    base = KPConfig(
        architecture=DEFORM_DEEPER,
        num_points=(4096, 1024, 256),
        conv_neighbors=(20, 20, 20),
        pool_neighbors=(20, 20),
        deform_conv_neighbors=(30, 30, 30),
        deform_pool_neighbors=(30, 30),
        in_features_dim=2,
        batch_num=2,
    )
    cfg = resolve_config(args, base)
    if not any("deform" in b for b in cfg.architecture):
        raise SystemExit("config has no deformable blocks — nothing to inspect")

    scenes = load_scenes(args.data, cfg.fusion != "none", cfg.num_views,
                         (cfg.image_height, cfg.image_width))
    ds = SphereDataset(scenes, cfg, training=False, seed=args.seed)
    batch = device_batch(ds.sample_batch())
    model = make_model(cfg, args.device, seed=args.seed)
    if args.checkpoint and restore_run(model, args.checkpoint) is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint}")

    summary = inspect_deformable(model, batch, cfg, args.output)
    print(json.dumps(summary["layers"], indent=2))
    print(f"wrote {len(summary['plys'])} PLYs to {args.output}")
    return summary


if __name__ == "__main__":
    main()
