"""MV-KPConv inference on a custom COLMAP-reconstructed dataset
(``mvkpconv_tpu/tools/test_colmap.py``; the reference's
KPConv-PyTorch/test_models_colmap.py and test_colmap_baseline_models.py):
assemble a scene from a laser scan + COLMAP cameras/poses/dense depths
(``data/colmap_io.py``), then run the voting sphere sweep with a trained
checkpoint and dump the predictions of the dataset's subsampled cloud as a
PLY in the ScanNet palette (``pred`` per point).

``--run`` is a training output directory of the port (``.pt`` checkpoints)
or of the JAX package (``.msgpack``); its ``parameters.txt`` gives the
model (MV-KPConv, or the 3D-only KPFCNN where ``fusion`` is ``none``) and
the image size the depth maps are resized to. The scan's labels are all
−1: nothing is scored. Runs on the first CUDA device unless ``--device``
names another.

Example:
  python -m mvkpconv_tpu_torch.tools.test_colmap --run outputs/fusion \\
      --sparse ws/sparse/0 --depths ws/stereo/depth_maps \\
      --laser scan.ply --images ws/images --alignment matrix_for_images.txt
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    """Returns the ``VotingTester`` after its sweep (``probs[0]``: the
    accumulated probabilities of the subsampled cloud)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run", required=True, help="training output dir")
    ap.add_argument("--sparse", required=True, help="COLMAP sparse model dir")
    ap.add_argument("--depths", required=True, help="dense depth_maps dir")
    ap.add_argument("--laser", required=True, help="laser scan ply")
    ap.add_argument("--images", default=None, help="undistorted images dir")
    ap.add_argument("--alignment", default=None, help="matrix_for_images.txt")
    ap.add_argument("--votes", type=float, default=10.0)
    ap.add_argument("--output-ply", default=None, help="prediction ply path")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the first CUDA "
                         "device; raises on a host without one)")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data.colmap_io import load_colmap_scene
    from mvkpconv_tpu_torch.data.meta import SCANNET_COLOR_PALETTE
    from mvkpconv_tpu_torch.data.spheres import SphereDataset
    from mvkpconv_tpu_torch.eval.voting import VotingTester
    from mvkpconv_tpu_torch.infer import batch_to_device, make_model, resolve_device
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.jax_checkpoint import restore_run
    from mvkpconv_tpu_torch.training.steps import make_eval_step
    from mvkpconv_tpu_torch.utils.ply import write_ply

    device = resolve_device(args.device)
    run = Path(args.run)
    cfg = KPConfig.load(run / "parameters.txt")
    scene = load_colmap_scene(
        args.sparse, args.depths, args.laser, args.alignment,
        resize_hw=(cfg.image_height, cfg.image_width), image_dir=args.images,
        max_frames=args.max_frames,
    )
    ds = SphereDataset([scene], cfg, training=False)
    # the JAX tool draws one batch to initialise its model; draw it here too,
    # so that the sweep starts from the same potentials and the same generator
    ds.sample_batch()

    model = make_model(cfg, device)
    restored = restore_run(model, run / "checkpoints")
    if restored is None:
        raise SystemExit(f"no checkpoint under {run}/checkpoints")
    print(f"restored step {restored[0]} from {restored[1]}")
    eval_step = make_eval_step(model, cfg)

    def predict(batch):
        return eval_step(batch_to_device(batch, device)).cpu().numpy()

    tester = VotingTester(ds, predict, cfg.num_classes, num_votes=args.votes,
                          ignore_label=cfg.ignore_label)
    tester.run(log_every=20)
    pred = tester.probs[0].argmax(-1).astype(np.int32)
    print(f"predicted {len(pred)} subsampled points "
          f"({np.bincount(pred, minlength=cfg.num_classes)})")
    if args.output_ply:
        palette = np.asarray(SCANNET_COLOR_PALETTE, np.uint8)
        colors = palette[np.clip(pred, 0, len(palette) - 1)]
        write_ply(args.output_ply, [ds.scenes[0]["points"], colors, pred],
                  ["x", "y", "z", "red", "green", "blue", "pred"])
        print(f"wrote {args.output_ply}")
    return tester


if __name__ == "__main__":
    main()
