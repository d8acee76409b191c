"""MVPNet whole-scene evaluation with sliding chunks
(``mvkpconv_tpu/tools/test_mvpnet.py``; the reference's
mvpnet/test_mvpnet_3d.py:70-233): stride-``--stride`` sliding windows over
each scene, each chunk resampled to ``--num-points``; the per-point
probabilities are accumulated onto the full cloud by ``point_indices`` and
averaged by coverage; the Evaluator's class table over the covered points.
The chunks go through the model ``cfg.batch_num`` at a time (eval-mode BN:
a chunk's result does not depend on its batch). ``--run`` may be a run
directory of the port or of the JAX package (``.msgpack`` checkpoints).

Runs on the first CUDA device unless ``--device`` names another.

Example:
  python -m mvkpconv_tpu_torch.tools.test_mvpnet --run outputs/mvpnet --data synthetic:2
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    """Returns ``(Evaluator, [per-scene dict of chunks, coverage])``."""
    ap = argparse.ArgumentParser(description=__doc__)
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes

    add_common_args(ap)
    ap.add_argument("--run", required=True)
    ap.add_argument("--num-points", type=int, default=8192)
    ap.add_argument("--num-views", type=int, default=3)
    ap.add_argument("--stride", type=float, default=0.5)
    args = ap.parse_args(argv)

    import numpy as np

    from mvkpconv_tpu_torch.data.chunks import ChunkDataset, SlidingChunks
    from mvkpconv_tpu_torch.eval.evaluator import Evaluator
    from mvkpconv_tpu_torch.infer import batch_to_device, make_model, resolve_device
    from mvkpconv_tpu_torch.tools.train_mvpnet import chunk_batch
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.jax_checkpoint import restore_run
    from mvkpconv_tpu_torch.training.steps import make_eval_step

    device = resolve_device(args.device)
    run = Path(args.run)
    cfg = KPConfig.load(run / "parameters.txt")
    scenes = load_scenes(args.data, True, args.num_views, (cfg.image_height, cfg.image_width),
                         seed_offset=100)
    ds = ChunkDataset(scenes, num_points=args.num_points, num_views=args.num_views, training=False)
    sliding = SlidingChunks(ds, stride=args.stride)

    model = make_model(cfg, device, seed=args.seed, kind="mvpnet")
    if restore_run(model, run / "checkpoints") is None:
        raise SystemExit(f"no checkpoint under {run}/checkpoints")
    eval_step = make_eval_step(model, cfg)

    ev = Evaluator(ignore_label=cfg.ignore_label)
    per_scene = []
    for si, scene in enumerate(scenes):
        n = len(scene["points"])
        probs_sum = np.zeros((n, cfg.num_classes), np.float32)
        coverage = np.zeros(n, np.float32)
        chunks = list(sliding.scene_chunks(si))
        for start in range(0, len(chunks), cfg.batch_num):
            group = chunks[start:start + cfg.batch_num]
            batch = {k: np.stack([c[k] for c in group]) for k in chunk_batch(group[0], False)}
            probs = eval_step(batch_to_device(batch, device)).cpu().numpy()
            for c, p in zip(group, probs):
                np.add.at(probs_sum, c["point_indices"], p)
                np.add.at(coverage, c["point_indices"], 1.0)
        seen = coverage > 0
        pred = (probs_sum[seen] / coverage[seen, None]).argmax(-1)
        ev.update(pred, scene["labels"][seen])
        per_scene.append({"chunks": len(chunks), "coverage": float(seen.mean())})
        print(f"scene {si}: {len(chunks)} chunks, coverage {seen.mean():.2%}")
    print(ev.table())
    return ev, per_scene


if __name__ == "__main__":
    main()
