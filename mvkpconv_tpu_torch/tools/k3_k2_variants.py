"""Device times of K3 and K2 at the bench's level-0 shapes, by kernel.

    python3 -m mvkpconv_tpu_torch.tools.k3_k2_variants [--counts]
    PYTHONPATH=DIR python3 mvkpconv_tpu_torch/tools/k3_k2_variants.py --earlier

Times come from ``torch.profiler``: the device time of every kernel an
operation launches, summed by kernel name, per call (mean of 20 calls after
a warm-up). A CUDA-event time around a wrapper call reads the wrapper's host
time once the kernel is shorter than that (0.05–0.08 ms a call), so these
are the figures to compare kernels by.

K3 (``csrc/segsum.cu``) at three level-0 gather sites of the bench pyramid
(B=4, N0=16384, K=30; the conv neighbors): the ``resnetb`` site (C = 32) and
the fused path's ``resnetb`` and ``simple`` sites (3 + Cin = 35, 69), with
f32 rows rounded by the kernel (``round_bf16``, as the default path hands
them), bf16 rows and f32 rows. Each site prints the plan's kernels alone
(``plan``), the sum with the plan cached (``sum``, as every gather VJP after
the first on a neighbor tensor), ``index_add_`` on the same rows in f32 and
the cast to bf16 that the path ran before the kernel rounded; each result is
held against the plain version (2⁻¹⁸·Σ|rows into a target|). With
``--counts`` the kernels are built with ``-DMVKP_CYCLES`` and each sum line
also carries K3's own counts for one call: targets stored whole, pieces of
long targets, and the cycles a warp spends reading lists, reading and adding
rows, and reducing and storing.

K2 (``csrc/pixel_select.cu``) at the bench shape (B=4, N=16384, V=5,
120×160, window 7, k=3), bf16 and f32 candidates, with the lanes a point
forced to 1, 2, 4, 8, 16 and 32 (``mvkp_pixel_topk_lanes``) and at the
kernel's default; indices held equal to the plain version's.

``--earlier`` times the same sites through whatever port ``PYTHONPATH``
puts first (an earlier commit unpacked by ``git archive``): its K3 on bf16
and f32 rows with the zero fill its wrapper launched, and its K2. Each line
names the checkout. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess

import numpy as np
import torch

from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
from mvkpconv_tpu_torch.infer import batch_to_device, bench_config
from mvkpconv_tpu_torch.models.kpfcnn import plan_architecture
from mvkpconv_tpu_torch.ops import _build
from mvkpconv_tpu_torch.ops.kernels import pixel_select as k2
from mvkpconv_tpu_torch.ops.kernels import segsum as k3
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid
from mvkpconv_tpu_torch.ops.unproject import project_to_views, unproject_depth, window_anchors

SEGSUM_REL = 2.0**-18
REPS = 20


def device_ms(fn, reps=REPS):
    """Device ms per call of ``fn``, in all and by kernel name; a profile
    with no device time recorded is taken again, up to three times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {e.key[:60]: e.self_device_time_total / 1e3 / reps
              for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
        if sum(by.values()) > 0:
            return sum(by.values()), by
    raise RuntimeError("device_ms: the profiler recorded no device time")


def k3_counts(lib, run):
    """K3's own counts over one call of ``run``."""
    buf = (ctypes.c_ulonglong * 6)()
    _build.check_launch("segsum_counts", lib.mvkp_segsum_counts(buf))  # empties them
    run()
    _build.check_launch("segsum_counts", lib.mvkp_segsum_counts(buf))
    rows, whole, pieces, *cycles = list(buf)
    items = max(1, whole + pieces)
    return {"rows": rows, "targets_whole": whole, "long_pieces": pieces,
            "cycles_per_item": {p: v / items for p, v in zip(("lists", "rows", "reduce_store"), cycles)}}


def sweep_k3(lib, pyr, cfg, counts, earlier):
    enc, _, _ = plan_architecture(cfg)
    index, ns = pyr.neighbors[0], cfg.num_points[0] + 1
    gen = torch.Generator(device=index.device)
    gen.manual_seed(0)
    flat = (index.long() + torch.arange(index.shape[0], device=index.device)[:, None, None] * ns).reshape(-1)
    rounds = "round_bf16" in inspect.signature(k3.segsum).parameters
    for site, c in (("L0_resnetb", enc[1][2] // 4), ("L0_resnetb_fused", 3 + enc[1][2] // 4),
                    ("L0_simple_fused", 3 + enc[0][1])):
        rows32 = torch.randn(index.numel(), c, generator=gen, device=index.device)
        cases = [(rows32.to(torch.bfloat16), False), (rows32, False)]
        if rounds:
            cases.insert(0, (rows32, True))
        for rows, rnd in cases:
            args = (rows, index, ns, rnd) if rnd else (rows, index, ns)
            want = k3.segsum_plain(*args)
            allowance = SEGSUM_REL * k3.segsum_plain(rows.abs(), *args[1:]) + 1e-30
            plans = k3.IndexPlans() if not earlier else None
            call = (lambda: k3.segsum(*args, plans=plans)) if not earlier else (lambda: k3.segsum(*args))
            got = call()
            over = float(((got - want).abs() / allowance).max())
            assert over <= 1.0, (site, over)
            out = torch.zeros(index.shape[0] * ns, c, device=index.device)
            src = rows.float()
            row = {"checkout": "earlier" if earlier else "this", "site": site, "c": c,
                   "rows": str(rows.dtype)[6:] + (" round_bf16" if rnd else ""), "err_over_allowance": over,
                   "bound_ms": (rows.numel() * rows.element_size() + index.numel() * 4 + want.numel() * 4)
                   / 3.35e12 * 1e3}
            # an earlier checkout's call keeps (or needs) no plan of its own
            row["call_ms"], row["call_kernels"] = device_ms(call)
            if not earlier:
                assert torch.equal(got, k3.segsum(*args)), (site, "not the same bits with a new plan")
                row["with_plan_ms"], row["with_plan_kernels"] = device_ms(lambda: k3.segsum(*args))
                row["plan_ms"], row["plan_kernels"] = device_ms(lambda: k3.segsum_plan(index, ns))
            row["index_add_ms"], _ = device_ms(lambda: out.index_add_(0, flat, src))
            if rows.dtype == torch.float32:
                row["cast_ms"], _ = device_ms(lambda: rows.to(torch.bfloat16))
            if counts:
                row["counts"] = k3_counts(lib, call)
            print(json.dumps(row), flush=True)


def sweep_k2(batch, cfg, earlier, lanes):
    p0 = batch["points"]
    image_xyz, _ = unproject_depth(batch["depth"], batch["intrinsics"], batch["poses"])
    u, v = project_to_views(p0, batch["intrinsics"], batch["poses"])
    w = cfg.pixel_window
    iu0 = window_anchors(u, cfg.image_width, w).contiguous()
    iv0 = window_anchors(v, cfg.image_height, w).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        img = image_xyz.to(dt).contiguous()
        want = k2.pixel_topk_plain(p0, img, iu0, iv0, w, cfg.pixel_knn)
        got = k2.pixel_topk(p0, img, iu0, iv0, w, cfg.pixel_knn)
        ms, by = device_ms(lambda: k2.pixel_topk(p0, img, iu0, iv0, w, cfg.pixel_knn))
        print(json.dumps({"checkout": "earlier" if earlier else "this", "kernel": "pixel_topk",
                          "dtype": str(dt)[6:], "lanes": lanes,
                          "rows_differ": int((got != want).any(-1).sum()), "ms": ms, "kernels": by}),
              flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--counts", action="store_true", help="K3's own counts (-DMVKP_CYCLES build)")
    parser.add_argument("--earlier", action="store_true", help="the port on PYTHONPATH is an earlier checkout")
    parser.add_argument("--k2-lanes", type=int, default=None, help="build K2 with this many lanes a point")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_k2_variants: needs a CUDA device")
    defines = (("MVKP_CYCLES",) if args.counts else ()) + (
        (f"MVKP_K2_LANES={args.k2_lanes}",) if args.k2_lanes else ())
    lib = _build.library(defines=defines)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "counts": args.counts, "earlier": args.earlier, "k2_lanes": args.k2_lanes}),
          flush=True)
    dev = torch.device("cuda", 0)
    cfg = bench_config()
    batch = batch_to_device(make_batch(cfg, cfg.batch_num, np.random.RandomState(0)), dev)
    sweep_k2(batch, cfg, args.earlier, args.k2_lanes or "default")
    pyr = build_pyramid(batch["points"], batch["mask"], cfg.pyramid_spec())
    sweep_k3(lib, pyr, cfg, args.counts, args.earlier)


if __name__ == "__main__":
    main()
