"""Train MVPNet (multi-view 2D features lifted onto points, then PointNet++)
on point chunks (``mvkpconv_tpu/tools/train_mvpnet.py``; the reference's
mvpnet/train_mvpnet_3d.py): ``ChunkDataset`` batches → ``Trainer.fit`` with
a validation of 4 chunk batches every epoch, best and last checkpoints,
resume. The 2D net is frozen unless ``--train-2d`` (the reference's
FROZEN_PATTERNS net_2d). ``--no-images`` trains the 3D-only PointNet++ baseline on the points'
colors.

Runs on the first CUDA device unless ``--device`` names another.

Example:
  python -m mvkpconv_tpu_torch.tools.train_mvpnet --data synthetic:4 --steps 300
"""

from __future__ import annotations

import argparse

HOST_KEYS = ("point_indices", "scene_index")


def chunk_batch(batch, no_images: bool):
    """A ``ChunkDataset`` batch without its host-only keys (and without the
    colors, which only the 3D-only baseline takes, as ``features``)."""
    drop = HOST_KEYS if no_images else HOST_KEYS + ("colors",)
    return {k: v for k, v in batch.items() if k not in drop}


def main(argv=None):
    """Returns the ``Trainer`` after its run."""
    ap = argparse.ArgumentParser(description=__doc__)
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes, resolve_config

    add_common_args(ap)
    ap.add_argument("--num-points", type=int, default=8192)
    ap.add_argument("--num-views", type=int, default=3)
    ap.add_argument("--train-2d", action="store_true", help="unfreeze the 2D net")
    ap.add_argument(
        "--no-images", action="store_true",
        help="train the 3D-only PointNet++ baseline on point colors "
             "(reference configs/scannet/3d_baselines, mvpnet/data/scannet_3d.py)",
    )
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from mvkpconv_tpu_torch.data.chunks import ChunkDataset
    from mvkpconv_tpu_torch.infer import batch_to_device, resolve_device
    from mvkpconv_tpu_torch.train import make_trainer
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.metrics import confusion_matrix, iou_from_confusion
    from mvkpconv_tpu_torch.training.steps import make_eval_step
    from mvkpconv_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    cfg = resolve_config(args, KPConfig(batch_num=4, num_views=args.num_views, epoch_steps=100))
    with_views = not args.no_images
    hw = (cfg.image_height, cfg.image_width)
    scenes = load_scenes(args.data, with_views, cfg.num_views, hw)
    val_scenes = load_scenes(args.val_data or "synthetic:2", with_views, cfg.num_views, hw,
                             seed_offset=100)
    ds = ChunkDataset(scenes, num_points=args.num_points, num_views=cfg.num_views,
                      use_color_feature=args.no_images, training=True, seed=args.seed)
    val_ds = ChunkDataset(val_scenes, num_points=args.num_points, num_views=cfg.num_views,
                          use_color_feature=args.no_images, training=False, seed=1)

    setup = make_trainer(cfg, device, seed=args.seed, freeze_2d=not args.train_2d,
                         kind="pn2" if args.no_images else "mvpnet")
    eval_step = make_eval_step(setup.model, cfg)

    def eval_fn():
        conf = np.zeros((cfg.num_classes, cfg.num_classes), np.int64)
        for _ in range(4):
            vb = val_ds.sample_batch(cfg.batch_num)
            probs = eval_step(batch_to_device(chunk_batch(vb, args.no_images), device))
            conf += confusion_matrix(probs.argmax(-1).cpu(), torch.from_numpy(vb["labels"]),
                                     cfg.num_classes, ignore_label=cfg.ignore_label).numpy()
        return {"miou": float(iou_from_confusion(conf).mean())}

    trainer = Trainer(setup.step, setup.model, setup.optimizer, args.output, cfg, eval_fn=eval_fn)
    trainer.maybe_resume()
    trainer.fit((chunk_batch(b, args.no_images) for b in ds.batches(cfg.batch_num)),
                max_steps=args.steps)
    return trainer


if __name__ == "__main__":
    main()
