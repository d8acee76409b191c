"""Train KPConv-family segmentation, baseline or MV-KPConv fusion
(``mvkpconv_tpu/tools/train_scannet.py``): synthetic or preprocessed scenes
→ ``SphereDataset`` → ``Trainer.fit`` (prefetch, train step, validation by
a voting sweep every epoch, best and last checkpoints, resume from the
output directory). The variant is ``--fusion``; without ``--path-2d`` an
MV-KPConv trains its UNet end to end.

Runs on one device: the first CUDA device unless ``--device`` names another
(``--device cpu`` runs every kernel's plain version). The JAX CLI's
multi-host scene sharding and data-parallel mesh are not ported (ROADMAP
queue 1, item 5).

Examples:
  python -m mvkpconv_tpu_torch.tools.train_scannet --fusion none --data synthetic --steps 200
  python -m mvkpconv_tpu_torch.tools.train_scannet --fusion early --data synthetic:6
"""

from __future__ import annotations

import argparse
from pathlib import Path


def default_config(fusion: str, in_features_dim: int):
    """The configuration the CLI trains without ``--config``: the default
    ``KPConfig`` (ARCHITECTURE_DEEPER at width 128, B=5, K=34, 5 views of
    120x160, f32) at N0=16384 over 5 levels."""
    from mvkpconv_tpu_torch.training.config import KPConfig

    return KPConfig(fusion=fusion, in_features_dim=in_features_dim,
                    num_points=(16384, 4096, 1024, 256, 64))


def main(argv=None):
    """Returns the ``Trainer`` after its run."""
    ap = argparse.ArgumentParser(description=__doc__)
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes, resolve_config

    add_common_args(ap)
    ap.add_argument("--fusion", default="none",
                    choices=["none", "early", "middle", "late"])
    ap.add_argument("--in-features-dim", type=int, default=None)
    ap.add_argument("--path-2d", default=None,
                    help="2D run output dir whose UNet weights to load "
                         "(frozen) into the fusion model (reference "
                         "config.path_2D, architectures_sphere.py:226-237)")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data.spheres import SphereDataset, device_batch
    from mvkpconv_tpu_torch.eval.voting import validation_sweep
    from mvkpconv_tpu_torch.infer import batch_to_device, resolve_device
    from mvkpconv_tpu_torch.train import make_trainer
    from mvkpconv_tpu_torch.training.steps import make_eval_step
    from mvkpconv_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    fusion = args.fusion
    in_dim = args.in_features_dim or (66 if fusion != "none" else 5)
    cfg = resolve_config(args, default_config(fusion, in_dim))
    # CLI flags override the config file's fusion choice
    cfg = cfg.replace(fusion=fusion)
    if args.in_features_dim:
        cfg = cfg.replace(in_features_dim=args.in_features_dim)
    elif cfg.base_feature_dim not in (1, 2, 4, 5, 7):
        cfg = cfg.replace(in_features_dim=in_dim)
    cfg.validate()
    with_views = args.views or fusion != "none"

    scenes = load_scenes(args.data, with_views, cfg.num_views,
                         (cfg.image_height, cfg.image_width))
    val_spec = args.val_data or "synthetic:2"
    val_scenes = load_scenes(val_spec, with_views, cfg.num_views,
                             (cfg.image_height, cfg.image_width), seed_offset=100)
    ds = SphereDataset(scenes, cfg, training=True, seed=args.seed)
    val_ds = SphereDataset(val_scenes, cfg, training=False, seed=args.seed + 1)

    # freeze the 2D net only when it comes pretrained (reference behavior);
    # without a checkpoint it must train end-to-end to be useful
    frozen = fusion != "none" and bool(args.path_2d)
    setup = make_trainer(cfg, device, seed=args.seed, freeze_2d=frozen)
    if frozen:
        from mvkpconv_tpu_torch.training.transfer import load_2d_checkpoint

        load_2d_checkpoint(setup.model.net_2d, args.path_2d)
        print(f"loaded frozen 2D weights from {args.path_2d}")
    eval_step = make_eval_step(setup.model, cfg)

    def eval_fn():
        return validation_sweep(
            val_ds,
            lambda batch: eval_step(batch_to_device(batch, device)).cpu().numpy(),
            cfg.num_classes,
            num_batches=max(cfg.validation_size // cfg.batch_num, 1),
            ignore_label=cfg.ignore_label,
            artifact_dir=Path(args.output) / "val_preds",
        )

    trainer = Trainer(setup.step, setup.model, setup.optimizer, args.output, cfg,
                      eval_fn=eval_fn)
    trainer.maybe_resume()
    trainer.fit((device_batch(b) for b in ds.batches()), max_steps=args.steps)
    return trainer


if __name__ == "__main__":
    main()
