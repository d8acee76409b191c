"""Export a trained model as a self-contained serving artifact
(``mvkpconv_tpu/tools/export_model.py``).

Freezes the weights and the whole inference step (the pyramid, the 2D UNet
and the lift for fusion models, the KPConv trunk, the softmax) into one
``torch.export`` program (``torch.export.save``), whose kernels are the
port's ``torch.library`` operators; ``mvkpconv_tpu_torch.eval.export.
ServingModel`` loads and runs it without the model code. With
``--whole-scene`` the artifact serves a full cloud (the sphere sweep and
the vote accumulation).

The artifact is traced on ``--device`` (default: the first CUDA device) and
its weights lie there; ``ServingModel.load(path, device=...)`` moves it.

Examples:
  # a trained run of the port (or of the JAX package: its .msgpack checkpoints)
  python -m mvkpconv_tpu_torch.tools.export_model \\
      --config run/parameters.txt --checkpoint run/checkpoints \\
      --artifact outputs/model.pt2 --selftest

  # the full-cloud program
  python -m mvkpconv_tpu_torch.tools.export_model --config run/parameters.txt \\
      --checkpoint run/checkpoints --whole-scene --artifact outputs/scene.pt2
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def random_inputs(spec, cfg, rng, device):
    """A valid random batch (or scene) of ``spec``'s shapes: every point
    valid, identity poses, pinhole intrinsics, uniform values elsewhere."""
    import torch

    out = {}
    for k, s in spec.items():
        if k == "mask":
            arr = np.ones(s.shape, bool)
        elif k == "poses":
            arr = np.tile(np.eye(4, dtype=np.float32), s.shape[:2] + (1, 1))
        elif k == "intrinsics":
            arr = np.zeros(s.shape, np.float32)
            arr[..., 0, 0] = arr[..., 1, 1] = 0.6 * cfg.image_width
            arr[..., 0, 2] = cfg.image_width / 2
            arr[..., 1, 2] = cfg.image_height / 2
            arr[..., 2, 2] = 1.0
        else:
            arr = rng.rand(*s.shape).astype(np.float32)
        out[k] = torch.tensor(arr, device=device)
    return out


def main(argv=None):
    """Returns (artifact path, export seconds, artifact bytes)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True, help="parameters.txt to load")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint dir to restore the model from (seeded weights if omitted)")
    ap.add_argument("--artifact", default="outputs/model.pt2")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="serving batch size baked into the artifact (default: cfg.batch_num)")
    ap.add_argument("--selftest", action="store_true",
                    help="reload the artifact and run one random batch through it")
    ap.add_argument("--whole-scene", action="store_true",
                    help="export the full-cloud program (sphere sweep and vote accumulation) "
                    "instead of the sphere-batch one")
    ap.add_argument("--max-points", type=int, default=262144,
                    help="whole-scene artifact: static subsampled-cloud point budget")
    ap.add_argument("--num-centers", type=int, default=256,
                    help="whole-scene artifact: static sphere-center budget (a multiple of "
                    "batch_num; pad real center lists with eval.export.pad_centers)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to trace on (default: the first CUDA device; raises "
                    "without one)")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.eval.export import (
        ServingModel,
        batch_spec_for,
        export_inference,
        export_whole_scene,
        infer_kind,
        save_exported,
        scene_spec_for,
    )
    from mvkpconv_tpu_torch.infer import make_model
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.jax_checkpoint import restore_run

    cfg = KPConfig.load(args.config)
    if args.batch_size:
        cfg = cfg.replace(batch_num=args.batch_size)
    kind = infer_kind(cfg)
    model = make_model(cfg, args.device, seed=args.seed)
    if args.checkpoint and restore_run(model, args.checkpoint) is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint}")
    device = next(model.parameters()).device

    t0 = time.perf_counter()
    if args.whole_scene:
        data = export_whole_scene(model, cfg, kind, args.max_points, args.num_centers)
        spec = scene_spec_for(cfg, args.max_points, args.num_centers)
    else:
        spec = batch_spec_for(cfg, kind)
        data = export_inference(model, cfg, kind, spec)
    seconds = time.perf_counter() - t0
    path = save_exported(data, args.artifact)
    print(f"exported {kind}{' whole-scene' if args.whole_scene else ''} "
          f"({len(data) / 1e6:.1f} MB, {seconds:.1f} s) -> {path}")

    if args.selftest:
        served = ServingModel.load(path)
        inputs = random_inputs(spec, cfg, np.random.RandomState(args.seed), device)
        out = served(inputs)
        if args.whole_scene:
            probs, votes = out["probs"].cpu().numpy(), out["votes"].cpu().numpy()
            print(f"selftest OK: device={served.device} probs shape={probs.shape} "
                  f"voted points={int((votes > 0).sum())}")
        else:
            probs = out.cpu().numpy()
            print(f"selftest OK: device={served.device} probs shape={probs.shape} "
                  f"checksum={probs.sum():.4f}")
    return path, seconds, len(data)


if __name__ == "__main__":
    main()
