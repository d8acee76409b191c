"""Voting test of a trained KPConv-family checkpoint
(``mvkpconv_tpu/tools/test_models.py``): loads ``parameters.txt`` and the
latest checkpoint of a training output directory (the port's ``.pt``, or the
JAX package's ``.msgpack`` in a JAX run directory), runs the voting sphere
sweep, prints the per-class IoU table, writes the prediction and potentials
PLYs under ``test_preds/`` (with ``--html`` a standalone viewer per scene
too) and scores the full-resolution clouds.

Runs on the first CUDA device unless ``--device`` names another.

Example:
  python -m mvkpconv_tpu_torch.tools.test_models --run outputs/run --data synthetic:2 --votes 10
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    """Returns the (subsampled, full-resolution) ``Evaluator`` pair."""
    ap = argparse.ArgumentParser(description=__doc__)
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes

    add_common_args(ap)
    ap.add_argument("--run", required=True, help="training output dir")
    ap.add_argument("--votes", type=float, default=30.0)
    ap.add_argument("--html", action="store_true",
                    help="also write standalone interactive HTML viewers "
                         "(pred/gt/error clouds) next to the PLYs")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data.meta import CLASS_NAMES
    from mvkpconv_tpu_torch.data.spheres import SphereDataset
    from mvkpconv_tpu_torch.eval.voting import VotingTester
    from mvkpconv_tpu_torch.infer import batch_to_device, make_model, resolve_device
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.jax_checkpoint import restore_run
    from mvkpconv_tpu_torch.training.steps import make_eval_step

    device = resolve_device(args.device)
    run = Path(args.run)
    cfg = KPConfig.load(run / "parameters.txt")
    with_views = cfg.fusion != "none"
    scenes = load_scenes(args.data, with_views, cfg.num_views,
                         (cfg.image_height, cfg.image_width), seed_offset=100)
    ds = SphereDataset(scenes, cfg, training=False, seed=args.seed)

    model = make_model(cfg, device, seed=args.seed)
    restored = restore_run(model, run / "checkpoints")
    if restored is None:
        raise SystemExit(f"no checkpoint found under {run}/checkpoints")
    print(f"restored step {restored[0]} from {restored[1]}")
    eval_step = make_eval_step(model, cfg)

    def predict(batch):
        return eval_step(batch_to_device(batch, device)).cpu().numpy()

    tester = VotingTester(ds, predict, cfg.num_classes, num_votes=args.votes,
                          ignore_label=cfg.ignore_label)
    ev = tester.run(log_every=20)
    print(ev.table())
    # prediction + potentials PLYs, like the reference's test artifact dumps
    # (tester.py:320-365)
    tester.save_artifacts(run / "test_preds", html=args.html, class_names=CLASS_NAMES)
    print(f"prediction/potentials plys written to {run / 'test_preds'}")
    full = tester.score_reprojected(scenes)
    print(f"\nfull-resolution mIoU {full.miou:.4f}  OA {full.overall_accuracy:.4f}")
    return ev, full


if __name__ == "__main__":
    main()
