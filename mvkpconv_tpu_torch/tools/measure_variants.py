"""Accuracy of every trainable system on one budget
(``mvkpconv_tpu/tools/measure_variants.py``): one row per system, the same
synthetic RGB-D scenes, data, budget and steps, a voting eval on held-out
scenes (chunks for MVPNet); the table of RESULTS.md, measured in the port.

The default protocol is the reference's two-stage recipe: the 2D UNet is
pretrained once on the training scenes' frames (``--steps-2d``, 600), saved
as a 2D run (``<out>/net_2d/checkpoints/model_best.pt``), then loaded frozen
into every fusion row and into MVPNet (``training/transfer.py``).
``--joint-2d`` trains the 2D net from scratch inside each fusion row.
``results.json`` has the JAX tool's keys; rerunning into the same ``--out``
skips the rows already in it (``--rerun`` measures them again) and reuses
the saved 2D net.

Runs on the first CUDA device unless ``--device`` names another
(``--device cpu`` with ``--tiny`` runs the CPU smoke size).

Example:
  python -m mvkpconv_tpu_torch.tools.measure_variants --steps 400 --out outputs/variants
"""

from __future__ import annotations

import argparse
import ast
import json
import time
from pathlib import Path

import numpy as np

ARCH_DEFORM = (
    "simple",
    "resnetb",
    "resnetb_strided",
    "resnetb",
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
    "nearest_upsample",
    "unary",
)
DEFORM = dict(fusion="none", in_features_dim=2, architecture=ARCH_DEFORM,
              deform_conv_neighbors=(40,) * 5, deform_pool_neighbors=(40,) * 4)
VARIANTS = {
    "kpconv_baseline": dict(fusion="none", in_features_dim=2),
    "kpconv_deformable": DEFORM,
    "kpconv_modulated": dict(DEFORM, modulated=True),
    "mvkpconv_early": dict(fusion="early", in_features_dim=66),
    "mvkpconv_middle": dict(fusion="middle", in_features_dim=66),
    "mvkpconv_late": dict(fusion="late", in_features_dim=66),
    "mvpnet": dict(fusion="none", in_features_dim=2),  # its own path below
}
HOST_KEYS = ("point_indices", "scene_index", "colors")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default="outputs/variants")
    ap.add_argument("--train-scenes", type=int, default=6)
    ap.add_argument("--val-scenes", type=int, default=2)
    ap.add_argument("--only", default=None, help="comma-separated subset, run in the order given")
    ap.add_argument("--joint-2d", action="store_true",
                    help="train the 2D net from scratch inside each fusion row instead of the "
                    "two-stage protocol (pretrain once, then frozen)")
    ap.add_argument("--steps-2d", type=int, default=600,
                    help="2D UNet pretraining steps of the two-stage protocol")
    ap.add_argument("--path-2d", default=None,
                    help="a 2D run directory (train_2d's, the port's or the JAX package's) to use "
                    "instead of pretraining the 2D net here")
    ap.add_argument("--override", action="append", default=[],
                    help="KPConfig field key=value applied to every row (repeatable), e.g. "
                    "--override deform_lr_factor=1.0")
    ap.add_argument("--family", default="boxes", choices=("boxes", "curved"),
                    help="synthetic scene family")
    ap.add_argument("--tiny", action="store_true",
                    help="minuscule shapes for smoke runs; the accuracies mean nothing there")
    ap.add_argument("--rerun", action="store_true",
                    help="measure again the rows already in <out>/results.json")
    ap.add_argument("--save-checkpoints", action="store_true",
                    help="write <out>/<row>/parameters.txt and checkpoints/ for each row "
                    "(tools/inspect_deform restores the deformable rows from them)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device; raises without one)")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns the results dict."""
    args = parse_args(argv)

    import torch

    from mvkpconv_tpu_torch.data import synthetic
    from mvkpconv_tpu_torch.data.chunks import ChunkDataset, Frames2DDataset
    from mvkpconv_tpu_torch.data.prefetch import prefetch
    from mvkpconv_tpu_torch.data.spheres import SphereDataset, device_batch
    from mvkpconv_tpu_torch.eval.voting import VotingTester
    from mvkpconv_tpu_torch.infer import batch_to_device, resolve_device
    from mvkpconv_tpu_torch.train import make_trainer
    from mvkpconv_tpu_torch.training.checkpoint import Checkpointer
    from mvkpconv_tpu_torch.training.config import KPConfig
    from mvkpconv_tpu_torch.training.metrics import confusion_matrix, iou_from_confusion
    from mvkpconv_tpu_torch.training.steps import make_eval_step
    from mvkpconv_tpu_torch.training.transfer import load_2d_checkpoint

    device = resolve_device(args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.tiny:
        h, w, views, scene_pts, frames = 24, 32, 2, 12_000, 4
    else:
        h, w, views, scene_pts, frames = 120, 160, 5, 120_000, 10

    def make_scenes(n, seed0, with_views=True):
        scenes = []
        for i in range(n):
            s = synthetic.make_scene(seed=seed0 + i, num_points=scene_pts, family=args.family)
            if with_views:
                s.update(synthetic.render_views(s, frames, h, w, seed=seed0 + i))
            scenes.append(s)
        return scenes

    base_kw = dict(
        num_points=(512, 128, 32, 16, 8) if args.tiny else (8192, 2048, 512, 128, 64),
        conv_neighbors=(10,) * 5 if args.tiny else (30,) * 5,
        pool_neighbors=(10,) * 4 if args.tiny else (30,) * 4,
        first_subsampling_dl=0.1 if args.tiny else 0.05,
        in_radius=1.2,
        batch_num=2 if args.tiny else 4,
        num_views=views,
        image_height=h,
        image_width=w,
        compute_dtype=torch.float32 if args.tiny else torch.bfloat16,
    )

    variants = dict(VARIANTS)
    if args.only:
        keep = [k.strip() for k in args.only.split(",")]
        unknown = [k for k in keep if k not in variants]
        if unknown:
            raise SystemExit(f"unknown variants {unknown}; choose from {list(variants)}")
        variants = {k: variants[k] for k in keep}

    # stage 1 of the two-stage protocol: the UNet pretrained once on the
    # training scenes' frames, saved as a 2D run, then frozen in every
    # fusion row and in MVPNet (whose lifted 2D features are its input)
    fusion_needed = any(v["fusion"] != "none" for v in variants.values()) or "mvpnet" in variants
    two_stage = fusion_needed and not args.joint_2d
    if two_stage and not args.path_2d:
        run_2d = out_dir / "net_2d"
        if (run_2d / "checkpoints" / "model_best.pt").exists():
            print(f"=== 2D net: reusing {run_2d} ===", flush=True)
        else:
            print(f"=== 2D pretrain ({args.steps_2d} steps) ===", flush=True)
            t0 = time.time()
            cfg2 = KPConfig(**{**base_kw, "in_features_dim": 2, "batch_num": 8, "learning_rate": 5e-3})
            ds2 = Frames2DDataset(make_scenes(args.train_scenes, 0), training=True, seed=0)
            setup2 = make_trainer(cfg2, device, seed=0, kind="unet2d")
            it = prefetch((batch_to_device(ds2.sample_batch(cfg2.batch_num), device)
                           for _ in iter(int, 1)), depth=2)
            for i in range(args.steps_2d):
                stats = setup2.step(next(it))
                if i % 100 == 0 or i == args.steps_2d - 1:
                    print(f"  2d step {i}: loss {float(stats['loss']):.3f}", flush=True)
            it.close()
            Checkpointer(run_2d / "checkpoints").save(
                {"step": args.steps_2d, "model": setup2.model.state_dict()}, args.steps_2d, is_best=True)
            print(f"  -> 2D net ready ({(time.time() - t0) / 60:.1f} min), saved to {run_2d}", flush=True)
        args.path_2d = str(run_2d)
    elif two_stage:
        print(f"=== 2D net: reusing {args.path_2d} ===", flush=True)

    results_path = out_dir / "results.json"
    results = {}
    if results_path.exists() and not args.rerun:
        results = json.loads(results_path.read_text())
    for name, overrides in variants.items():
        if name in results and not args.rerun:
            print(f"=== {name}: already in {results_path}, skipping (--rerun to force) ===", flush=True)
            continue
        t_start = time.time()
        print(f"=== {name} ===", flush=True)
        cfg = KPConfig(**base_kw, **overrides)
        for ov in args.override:
            k, v = ov.split("=", 1)
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass  # a string
            cfg = cfg.replace(**{k: v})
        with_views = cfg.fusion != "none" or name == "mvpnet"
        train_scenes = make_scenes(args.train_scenes, 0, with_views)
        val_scenes = make_scenes(args.val_scenes, 100, with_views)

        if name == "mvpnet":
            kind = "mvpnet"
            ds = ChunkDataset(train_scenes, num_points=8192, num_views=views, training=True, seed=0)
            val_ds = ChunkDataset(val_scenes, num_points=8192, num_views=views, training=False, seed=1)

            def to_device(b):
                return batch_to_device({k: v for k, v in b.items() if k not in HOST_KEYS}, device)
        else:
            kind = "kpfcnn" if cfg.fusion == "none" else "mvkpconv"
            ds = SphereDataset(train_scenes, cfg, training=True, seed=0)
            val_ds = SphereDataset(val_scenes, cfg, training=False, seed=1)

            def to_device(b):
                return batch_to_device(device_batch(b), device)

        frozen = kind in ("mvkpconv", "mvpnet") and two_stage
        setup = make_trainer(cfg, device, seed=0, freeze_2d=frozen, kind=kind)
        if frozen:
            # stage 2: the pretrained 2D net, frozen
            load_2d_checkpoint(setup.model.net_2d, args.path_2d)
        eval_step = make_eval_step(setup.model, cfg)

        losses = []
        batches = prefetch((to_device(ds.sample_batch(cfg.batch_num)) for _ in iter(int, 1)), depth=2)
        for i in range(args.steps):
            stats = setup.step(next(batches))
            if i % 100 == 0 or i == args.steps - 1:
                losses.append(float(stats["loss"]))
                print(f"  step {i}: loss {losses[-1]:.3f}", flush=True)
        batches.close()

        if args.save_checkpoints:
            vdir = out_dir / name
            vdir.mkdir(parents=True, exist_ok=True)
            cfg.save(vdir / "parameters.txt")
            Checkpointer(vdir / "checkpoints").save(
                {"step": args.steps, "model": setup.model.state_dict(),
                 "optimizer": setup.optimizer.state_dict()}, args.steps)
            print(f"  saved checkpoint -> {vdir}/checkpoints", flush=True)

        def predict(b):
            return eval_step(to_device(b)).float().cpu().numpy()

        if name == "mvpnet":
            # chunk eval: the confusion over sampled validation chunks
            conf = np.zeros((cfg.num_classes, cfg.num_classes), np.int64)
            for _ in range(3 if args.tiny else 30):
                vb = val_ds.sample_batch(cfg.batch_num)
                pred = torch.from_numpy(predict(vb).argmax(-1))
                conf += confusion_matrix(pred, torch.from_numpy(vb["labels"]), cfg.num_classes,
                                         ignore_label=cfg.ignore_label).numpy()
            miou = float(np.asarray(iou_from_confusion(conf)).mean())
            oa = float(np.trace(conf) / max(conf.sum(), 1))
        else:
            tester = VotingTester(val_ds, predict, cfg.num_classes,
                                  num_votes=1.0 if args.tiny else 10.0, ignore_label=cfg.ignore_label)
            ev = tester.run(max_batches=4 if args.tiny else 200)
            miou = float(ev.miou)
            oa = float(ev.overall_accuracy)

        results[name] = {
            "miou": round(miou, 4),
            "oa": round(oa, 4),
            "final_loss": round(losses[-1], 4),
            "steps": args.steps,
            "minutes": round((time.time() - t_start) / 60, 1),
            "protocol": ("two_stage_frozen_2d" if frozen else
                         ("joint_2d" if kind in ("mvkpconv", "mvpnet") else "3d_only")),
        }
        print(f"  -> {results[name]}", flush=True)
        results_path.write_text(json.dumps(results, indent=2))

    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
