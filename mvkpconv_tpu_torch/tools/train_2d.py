"""Train the 2D UNet-ResNet34 semantic segmentation network
(``mvkpconv_tpu/tools/train_2d.py``; the reference's mvpnet/train_2d.py):
``Frames2DDataset`` batches → ``Trainer.fit`` with a full-frame validation
sweep (``eval/eval2d.py``) every epoch, an image | label | prediction PNG
panel per validation, best and last checkpoints, resume. Its checkpoint is
the frozen 2D net of ``train_scannet --path-2d``, ``train_mvpnet`` and
``precompute_2d``.

Runs on the first CUDA device unless ``--device`` names another
(``--device cpu`` runs everything in plain PyTorch).

Example:
  python -m mvkpconv_tpu_torch.tools.train_2d --data synthetic:4 --steps 500
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    """Returns the ``Trainer`` after its run."""
    ap = argparse.ArgumentParser(description=__doc__)
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes, resolve_config

    add_common_args(ap)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument(
        "--pretrained", default=None, metavar="RESNET34_PTH",
        help="torchvision ResNet34 state-dict file to initialize the encoder "
        "(the reference uses resnet34(pretrained=True), unet_resnet34.py:17)",
    )
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data.chunks import Frames2DDataset
    from mvkpconv_tpu_torch.eval.eval2d import evaluate_frames
    from mvkpconv_tpu_torch.infer import batch_to_device, resolve_device
    from mvkpconv_tpu_torch.train import make_trainer
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.steps import make_eval_step
    from mvkpconv_tpu_torch.training.trainer import Trainer
    from mvkpconv_tpu_torch.utils.visualize import save_2d_panel

    device = resolve_device(args.device)
    cfg = resolve_config(
        args, KPConfig(learning_rate=args.lr, momentum=0.9, batch_num=8, epoch_steps=100))
    hw = (cfg.image_height, cfg.image_width)
    scenes = load_scenes(args.data, True, cfg.num_views, hw)
    val_scenes = load_scenes(args.val_data or "synthetic:2", True, cfg.num_views, hw, seed_offset=100)
    ds = Frames2DDataset(scenes, training=True, seed=args.seed)
    val_ds = Frames2DDataset(val_scenes, training=False)

    setup = make_trainer(cfg, device, seed=args.seed, kind="unet2d")
    if args.pretrained:
        from mvkpconv_tpu_torch.models.unet2d import load_torch_resnet34_encoder

        load_torch_resnet34_encoder(setup.model, args.pretrained)
    eval_step = make_eval_step(setup.model, cfg)
    trainer = None

    def eval_fn():
        panel = []

        def probs_fn(batch):
            probs = eval_step(batch_to_device(batch, device)).cpu().numpy()
            if not panel:  # image | label | prediction, the reference's TB panels
                panel.append(Path(args.output) / "panels" / f"step{trainer.step:06d}.png")
                save_2d_panel(panel[0], batch["images"][0], batch["labels"][0], probs[0].argmax(-1))
            return probs

        # the full validation set: the sweep test_2d scores a checkpoint with
        ev = evaluate_frames(probs_fn, val_ds, batch_size=cfg.batch_num, ignore_label=cfg.ignore_label)
        return {"miou": ev.miou, "class_iou": ev.class_iou}

    trainer = Trainer(setup.step, setup.model, setup.optimizer, args.output, cfg, eval_fn=eval_fn)
    trainer.maybe_resume()
    trainer.fit(ds.batches(cfg.batch_num), max_steps=args.steps)
    return trainer


if __name__ == "__main__":
    main()
