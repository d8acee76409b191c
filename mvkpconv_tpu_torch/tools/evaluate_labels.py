"""Standalone mIoU evaluation of per-scan prediction files vs ground truth
(``mvkpconv_tpu/tools/evaluate_labels.py``).

Replaces the reference's ScanNet-benchmark-style evaluator CLI
(mvpnet/evaluate_3d.py:95-160: match ``<scan>.txt`` prediction files to
ground-truth files of the same name, accumulate a confusion matrix, print
the per-class IoU table). Labels are one integer per line (train ids in
[0, C) with negatives ignored — pass ``--nyu40`` for nyu40-id files like
the official benchmark's). Host code only: it needs no card.

Example:
  python -m mvkpconv_tpu_torch.tools.evaluate_labels \\
      --pred-path outputs/preds --gt-path data/gt
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pred-path", required=True)
    ap.add_argument("--gt-path", required=True)
    ap.add_argument("--num-classes", type=int, default=20)
    ap.add_argument(
        "--nyu40", action="store_true",
        help="files carry nyu40 ids (official benchmark format); they are "
             "mapped to the 20 train classes before scoring",
    )
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data.meta import CLASS_NAMES
    from mvkpconv_tpu_torch.data.scannet_io import nyu40_to_train_ids
    from mvkpconv_tpu_torch.eval.evaluator import Evaluator

    pred_dir, gt_dir = Path(args.pred_path), Path(args.gt_path)
    pred_files = sorted(pred_dir.glob("*.txt"))
    if not pred_files:
        raise SystemExit(f"no .txt prediction files under {pred_dir}")
    names = (
        CLASS_NAMES[: args.num_classes]
        if args.num_classes <= len(CLASS_NAMES)
        else [str(i) for i in range(args.num_classes)]
    )
    ev = Evaluator(class_names=tuple(names))
    lut = nyu40_to_train_ids()
    for pf in pred_files:
        gf = gt_dir / pf.name
        if not gf.is_file():
            raise SystemExit(f"prediction {pf.name} has no ground-truth file")
        pred = np.loadtxt(pf, dtype=np.int64, ndmin=1)
        gt = np.loadtxt(gf, dtype=np.int64, ndmin=1)
        if len(pred) != len(gt):
            raise SystemExit(f"{pf.name}: {len(pred)} preds vs {len(gt)} gts")
        if args.nyu40:
            pred = lut[np.clip(pred, 0, 40)]
            gt = lut[np.clip(gt, 0, 40)]
        ev.update(pred.astype(np.int32), gt.astype(np.int32))
        print(f"scored {pf.name} ({len(pred)} points)")
    print()
    print(ev.table())
    return ev


if __name__ == "__main__":
    main()
