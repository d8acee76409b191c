"""Offline ScanNet preprocessing CLI (``mvkpconv_tpu/tools/preprocess.py``).

Replaces mvpnet/data/preprocess/preprocess.py's __main__ and
compute_label_weights.py: builds the per-split pickle cache from raw scans
(``data/scannet_io.py``; the pickle the training CLIs' ``--data`` reads) and
writes class weights. Host code only: it runs no model and needs no card.

Example:
  python -m mvkpconv_tpu_torch.tools.preprocess --scans /data/scans \
      --split-file scannetv2_train.txt --output scannetv2_train.pkl
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scans", required=True, help="root dir containing scan dirs")
    ap.add_argument("--split-file", required=True, help="txt with one scan id per line")
    ap.add_argument("--output", required=True, help="output .pkl path")
    ap.add_argument("--weights-output", default=None,
                    help="optional path for 1/log(1.2+freq) class weights")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data import scannet_io

    scan_ids = [
        line.strip()
        for line in Path(args.split_file).read_text().splitlines()
        if line.strip()
    ]
    scenes = scannet_io.preprocess_split(
        args.scans, scan_ids, args.output, verbose=args.verbose
    )
    print(f"wrote {len(scenes)} scenes to {args.output}")
    if args.weights_output:
        w = scannet_io.compute_label_weights(scenes)
        np.savetxt(args.weights_output, w)
        print(f"wrote label weights to {args.weights_output}")
    return scenes


if __name__ == "__main__":
    main()
