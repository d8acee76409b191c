"""Offline training-curve analysis from run logs
(``mvkpconv_tpu/tools/plot_convergence.py``).

Replaces KPConv-PyTorch/plot_convergence.py:104-142 (parsers for
training.txt / val IoU logs) with matplotlib output optional — when
matplotlib is unavailable the tool prints a text summary only (and raises
where ``--output`` asks for the plot). It reads the
``training.txt`` of a run of the port (``training/logger.py``) or of the
JAX package: the same columns.

Example:
  python -m mvkpconv_tpu_torch.tools.plot_convergence outputs/run1 outputs/run2
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def parse_training_txt(run_dir):
    """Columns: epochs steps out_loss offset_loss train_accuracy time."""
    path = Path(run_dir) / "training.txt"
    rows = []
    for line in path.read_text().splitlines()[1:]:
        parts = line.split()
        if len(parts) >= 6:
            rows.append([float(p) for p in parts[:6]])
    return np.asarray(rows) if rows else np.zeros((0, 6))


def smooth(x, window: int = 25):
    if len(x) < 2:
        return x
    w = min(window, max(len(x) // 4, 1))
    kernel = np.ones(w) / w
    return np.convolve(x, kernel, mode="valid")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("runs", nargs="+", help="training output dirs")
    ap.add_argument("--output", default=None, help="save plot to this path")
    args = ap.parse_args(argv)

    curves = {}
    for run in args.runs:
        data = parse_training_txt(run)
        if len(data):
            curves[run] = data

    for run, data in curves.items():
        loss, acc = data[:, 2], data[:, 4]
        print(
            f"{run}: {len(data)} steps | loss {loss[0]:.3f} → "
            f"{smooth(loss)[-1]:.3f} | acc {acc[0]:.3f} → {smooth(acc)[-1]:.3f} "
            f"| wall {data[-1, 5]:.0f}s"
        )

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as err:
        if args.output:
            raise ImportError(f"--output {args.output}: the plot needs matplotlib") from err
        print("matplotlib is not installed: text summary only")
        return curves
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for run, data in curves.items():
        axes[0].plot(data[:, 1], smooth(data[:, 2], 1), alpha=0.25)
        axes[0].plot(data[len(data) - len(smooth(data[:, 2])):, 1],
                     smooth(data[:, 2]), label=run)
        axes[1].plot(data[len(data) - len(smooth(data[:, 4])):, 1],
                     smooth(data[:, 4]), label=run)
    axes[0].set_xlabel("step"), axes[0].set_ylabel("loss"), axes[0].legend()
    axes[1].set_xlabel("step"), axes[1].set_ylabel("train accuracy")
    out = args.output or "convergence.png"
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")
    return curves


if __name__ == "__main__":
    main()
