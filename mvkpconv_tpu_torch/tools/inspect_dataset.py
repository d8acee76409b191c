"""SphereDataset introspection: timings, occupancy, budget calibration
(``mvkpconv_tpu/tools/inspect_dataset.py``, over the port's ``SphereDataset``;
host code only, it needs no card).

The analog of the reference's dataset debug harnesses
(KPConv-PyTorch/datasets/ScanNet_sphere_color.py:1694-1862 ``debug_timing``,
``debug_batch_and_neighbors_calib``, ``debug_upsampling``): sample spheres
from the real pipeline and report

  * per-stage host sampling wall-clock (pick_center / crop / features /
    select_frames / augment / pad) — where the producer thread spends time;
  * sphere occupancy — raw in-sphere point counts vs the level-0 budget
    (``num_points[0]``): overflow rate (sphere had to be random-cropped)
    and padding fraction (budget wasted on shadow points);
  * exact host-side neighbor/pool count distributions per pyramid level vs
    the configured static budgets (``conv_neighbors``/``pool_neighbors``):
    truncation rate (points whose true neighborhood exceeds the budget —
    the reference's "90% untouched" calibration criterion,
    ScanNet_sphere.py:1326-1576) and over-provision headroom.

Budgets whose truncation rate exceeds ``--max-truncation`` (default: the
complement of the 90% criterion) or that waste >4x headroom at p99 are
flagged ``MISCALIBRATED``; the verdicts land in the JSON report and the
process exits nonzero with ``--strict``.

Example:
  python -m mvkpconv_tpu_torch.tools.inspect_dataset --data synthetic:2 \\
      --spheres 32 --output outputs/inspect_ds
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def neighbor_distributions(dataset, num_spheres: int):
    """Exact per-level neighbor/pool counts over freshly sampled spheres.

    Mirrors data/calibration.py's measurement but keeps the full count
    distributions (calibration reduces straight to one percentile, which
    is exactly what this tool exists to second-guess).
    """
    from mvkpconv_tpu_torch.data.spheres import grid_subsample_np

    cfg = dataset.cfg
    spec = cfg.pyramid_spec()
    levels = spec.num_levels
    out = {
        "points": [[] for _ in range(levels)],
        "conv": [[] for _ in range(levels)],
        "pool": [[] for _ in range(levels - 1)],
    }
    for _ in range(num_spheres):
        item = dataset.sample_sphere()
        pts = item["points"][item["mask"]]
        level_pts = [pts]
        for lv in range(levels):
            p = level_pts[lv]
            out["points"][lv].append(len(p))
            rc = spec.cell_size(lv) * spec.conv_radius
            d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
            out["conv"][lv].append((d2 < rc**2).sum(1))
            if lv + 1 < levels:
                sub, _, _ = grid_subsample_np(
                    p, p, np.zeros(len(p), np.int32), spec.cell_size(lv + 1), 1
                )
                d2p = ((sub[:, None] - p[None]) ** 2).sum(-1)
                out["pool"][lv].append((d2p < rc**2).sum(1))
                level_pts.append(sub)
    return out


def budget_verdicts(dists, cfg, max_truncation: float, max_headroom: float):
    """Compare measured neighbor-count distributions against the static
    budgets; one verdict row per (kind, level)."""
    rows = []
    for kind, budgets in (("conv", cfg.conv_neighbors),
                          ("pool", cfg.pool_neighbors)):
        for lv, per_sphere in enumerate(dists[kind]):
            counts = np.concatenate(per_sphere)
            budget = int(budgets[lv])
            trunc = float((counts > budget).mean())
            p50, p90, p99 = (float(np.percentile(counts, q))
                             for q in (50, 90, 99))
            flags = []
            if trunc > max_truncation:
                flags.append(
                    f"truncates {trunc:.1%} of neighborhoods "
                    f"(> {max_truncation:.1%}); raise toward p90={p90:.0f}"
                )
            if p99 > 0 and budget > max_headroom * p99:
                flags.append(
                    f"budget {budget} is >{max_headroom:.0f}x the p99 "
                    f"count {p99:.0f}; shrink to save gather rows"
                )
            rows.append({
                "kind": kind, "level": lv, "budget": budget,
                "count_p50": p50, "count_p90": p90, "count_p99": p99,
                "count_max": int(counts.max()),
                "truncation_rate": trunc,
                "ok": not flags,
                "flags": flags,
            })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    from mvkpconv_tpu_torch.tools.common import add_common_args, load_scenes, resolve_config

    add_common_args(ap)
    ap.add_argument("--spheres", type=int, default=32,
                    help="spheres to sample for the statistics")
    ap.add_argument("--max-truncation", type=float, default=0.10,
                    help="flag a budget once it truncates more than this "
                    "fraction of true neighborhoods (reference criterion: "
                    "90%% of neighborhoods untouched)")
    ap.add_argument("--max-headroom", type=float, default=4.0,
                    help="flag a budget more than this multiple of the p99 "
                    "measured count (wasted gather rows)")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero if any budget is miscalibrated")
    args = ap.parse_args(argv)

    from mvkpconv_tpu_torch.data.spheres import SphereDataset
    from mvkpconv_tpu_torch.training.config import KPConfig

    cfg = resolve_config(args, KPConfig(fusion="none", in_features_dim=5))
    cfg.validate()
    scenes = load_scenes(
        args.data, args.views, cfg.num_views,
        (cfg.image_height, cfg.image_width),
    )
    t0 = time.perf_counter()
    ds = SphereDataset(scenes, cfg, training=True, seed=args.seed)
    setup_s = time.perf_counter() - t0

    dists = neighbor_distributions(ds, args.spheres)
    rows = budget_verdicts(dists, cfg, args.max_truncation, args.max_headroom)

    # ---- report ------------------------------------------------------
    print(f"{len(scenes)} scenes, {args.spheres} spheres sampled, "
          f"dataset setup {setup_s:.2f}s "
          f"(subsample + potentials + rgbd overlap)")

    print("\nper-stage sample_sphere wall-clock (ms/call):")
    total_ms = 0.0
    for stage, ts in ds.stage_times.items():
        ms = 1e3 * np.asarray(ts)
        total_ms += float(ms.mean())
        print(f"  {stage:<14} mean {ms.mean():7.3f}  p90 "
              f"{np.percentile(ms, 90):7.3f}  max {ms.max():7.3f}")
    rate = 1e3 / total_ms if total_ms else float("inf")
    print(f"  {'TOTAL':<14} mean {total_ms:7.3f}  -> {rate:,.0f} spheres/s "
          f"single-thread host rate")

    n0 = cfg.num_points[0]
    raw = np.asarray(ds.sphere_counts, np.float64)
    occ = np.minimum(raw, n0) / n0
    print(f"\nsphere occupancy vs num_points[0]={n0}:")
    print(f"  raw in-sphere points: p10 {np.percentile(raw, 10):,.0f}  "
          f"p50 {np.percentile(raw, 50):,.0f}  p90 {np.percentile(raw, 90):,.0f}")
    print(f"  overflow (sphere random-cropped): {(raw > n0).mean():.1%} of spheres")
    print(f"  padding fraction (budget wasted): {1 - occ.mean():.1%} mean")

    lvl_pts = [np.asarray(c, np.float64) for c in dists["points"]]
    print("\nper-level point counts vs num_points budgets:")
    for lv, c in enumerate(lvl_pts):
        b = cfg.num_points[lv]
        print(f"  L{lv}: budget {b:>6}  measured p50 "
              f"{np.percentile(c, 50):>8,.0f}  p99 {np.percentile(c, 99):>8,.0f}"
              f"{'  OVERFLOWS' if np.percentile(c, 99) > b else ''}")

    print("\nneighbor budgets vs measured distributions:")
    bad = [r for r in rows if not r["ok"]]
    for r in rows:
        tag = "ok          " if r["ok"] else "MISCALIBRATED"
        print(f"  {tag} {r['kind']}[L{r['level']}] budget {r['budget']:>3}  "
              f"counts p50/p90/p99 {r['count_p50']:.0f}/{r['count_p90']:.0f}/"
              f"{r['count_p99']:.0f}  truncation {r['truncation_rate']:.1%}")
        for f in r["flags"]:
            print(f"      -> {f}")

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    report = {
        "setup_s": setup_s,
        "stage_ms": {k: float(np.mean(v) * 1e3)
                     for k, v in ds.stage_times.items()},
        "spheres_per_sec_single_thread": rate,
        "sphere_counts": {"p50": float(np.percentile(raw, 50)),
                          "overflow_rate": float((raw > n0).mean()),
                          "padding_fraction": float(1 - occ.mean())},
        "level_points": [{"budget": int(cfg.num_points[lv]),
                          "p50": float(np.percentile(c, 50)),
                          "p99": float(np.percentile(c, 99))}
                         for lv, c in enumerate(lvl_pts)],
        "budgets": rows,
    }
    (out / "inspect_dataset.json").write_text(json.dumps(report, indent=1))
    print(f"\nreport written to {out / 'inspect_dataset.json'}")
    if bad:
        print(f"{len(bad)} budget(s) MISCALIBRATED")
        if args.strict:
            raise SystemExit(2)
    return report


if __name__ == "__main__":
    main()
