"""Standalone evaluation of a trained 2D UNet-ResNet34 checkpoint
(``mvkpconv_tpu/tools/test_2d.py``; the reference's mvpnet/test_2d.py): loads
``parameters.txt`` and the latest checkpoint (``--best``: ``model_best.pt``)
of a ``train_2d`` output directory (the port's, or the JAX package's with
``.msgpack`` checkpoints), sweeps every frame of ``--data`` once and
prints the Evaluator's per-class table, also written to
``test_2d_IoUs.txt``. On the validation scenes of the run it reproduces the
trainer's last ``val_miou``.

Runs on the first CUDA device unless ``--device`` names another.

Example:
  python -m mvkpconv_tpu_torch.tools.test_2d --run outputs/run2d --data synthetic:2
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    """Returns the ``Evaluator``."""
    ap = argparse.ArgumentParser(description=__doc__)
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes

    add_common_args(ap)
    ap.add_argument("--run", required=True, help="train_2d output dir")
    ap.add_argument("--best", action="store_true",
                    help="score model_best.pt (.msgpack) instead of the latest checkpoint")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data.chunks import Frames2DDataset
    from mvkpconv_tpu_torch.eval.eval2d import evaluate_frames
    from mvkpconv_tpu_torch.infer import batch_to_device, make_model, resolve_device
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.jax_checkpoint import restore_run
    from mvkpconv_tpu_torch.training.steps import make_eval_step

    device = resolve_device(args.device)
    run = Path(args.run)
    cfg = KPConfig.load(run / "parameters.txt")
    scenes = load_scenes(args.data, True, cfg.num_views, (cfg.image_height, cfg.image_width),
                         seed_offset=100)
    ds = Frames2DDataset(scenes, training=False)
    if not len(ds):
        raise SystemExit("no frames in --data (need rendered views)")

    model = make_model(cfg, device, seed=args.seed, kind="unet2d")
    restored = restore_run(model, run / "checkpoints", best=args.best)
    if restored is None:
        raise SystemExit(f"no {'best ' if args.best else ''}checkpoint in {run}")
    print(f"evaluating step-{restored[0]} {'best ' if args.best else ''}checkpoint "
          f"over {len(ds)} frames")
    eval_step = make_eval_step(model, cfg)
    ev = evaluate_frames(lambda b: eval_step(batch_to_device(b, device)).cpu().numpy(), ds,
                         batch_size=cfg.batch_num, ignore_label=cfg.ignore_label)
    print(ev.table())
    out = run / "test_2d_IoUs.txt"
    out.write_text(ev.table() + "\n")
    print(f"table written to {out}")
    return ev


if __name__ == "__main__":
    main()
