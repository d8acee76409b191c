"""Times K4's forward, or counts its cycles, at the conv sites of the bench pyramid.

    python3 -m mvkpconv_tpu_torch.tools.kpconv_variants [--cycles]

The forward kernel (``csrc/kpconv.cu``) takes 64, 32 or 16 queries a block;
``plan_fwd`` there chooses. This script forces each choice in turn through
``mvkp_kpconv_fwd_tune`` (a hook for measurements; the port never calls it)
at one conv site of every level of the bench configuration (B=4, N0=16384,
K=30, M=15; the level-0 ``simple`` site 66→64, then ``resnetb`` sites 32→32 …
512→512), bf16 and f32 rows, and prints one JSON line per site: ms per
variant (CUDA events, 20 launches after a warm-up), the planned variant's
first, ``<n>q`` for n queries a block, and the einsum chain on a prebuilt
influence beside them. Every variant's output is held against the planned
one's (to 1e-5 of the largest output: the variants add the k-steps in
different orders). 32 and 16 queries take 64-column tiles also where Cout is
32.

With ``--cycles`` it builds the kernels with ``-DMVKP_CYCLES`` instead, which
makes the forward add up ``clock64`` differences at its phase boundaries (lane
0 of every warp), and prints per site, for bf16 rows and the planned variant:
``ms`` of the instrumented kernel, its blocks, ``block_cycles`` (mean cycles
from a block's start to its end) and, as means per warp and block over all
chunks of channels, ``sums`` (phase 1, the per-query sums), ``sums_rows_wait``
(of it, waiting for the staged rows), ``product_wait`` (phase 2's waits for W
and its barriers) and ``product`` (the rest of phase 2). No profiler attaches
to a kernel's inside on a sealed machine; this does.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
from mvkpconv_tpu_torch.infer import batch_to_device, bench_config
from mvkpconv_tpu_torch.models import blocks
from mvkpconv_tpu_torch.models.kernel_points import kernel_point_positions
from mvkpconv_tpu_torch.models.kpfcnn import plan_architecture
from mvkpconv_tpu_torch.ops import _build
from mvkpconv_tpu_torch.ops.gather import group_points, pad_shadow_row
from mvkpconv_tpu_torch.ops.kernels import kpconv as k4
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid

VARIANTS = (0, 64, 32, 16)  # queries per block, 0: the plan's choice


def _ms(fn, reps=20):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


FWD_WARPS = 16  # csrc/kpconv.cu kFwdWarps


def sites(dev):
    """(name, queries, cin, cout, rel, nx in f32, kernel points, W, extent) of
    one conv site per level, with seeded normal features and weights."""
    cfg = bench_config()
    batch = batch_to_device(make_batch(cfg, cfg.batch_num, np.random.RandomState(0)), dev)
    pyr = build_pyramid(batch["points"], batch["mask"], cfg.pyramid_spec())
    enc, _, _ = plan_architecture(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m = cfg.num_kernel_points
    found = [("L0_simple", 0, enc[0], enc[0][1], enc[0][2] // 2)]
    for level in range(len(pyr.points)):
        entry = next(e for e in enc if e[4] == level and e[0] == "resnetb")
        found.append((f"L{level}_resnetb", level, entry, entry[2] // 4, entry[2] // 4))
    for name, level, entry, cin, cout in found:
        pts, inds = pyr.points[level], pyr.neighbors[level]
        radius = entry[3]
        extent = radius * cfg.kp_extent / cfg.conv_radius
        kp = torch.from_numpy(kernel_point_positions(radius, m)).to(dev)
        s_pad = torch.cat([pts, torch.full_like(pts[:, :1], 1e6)], dim=1)
        rel = (group_points(s_pad, inds) - pts[:, :, None, :]).contiguous()
        x = torch.randn(*pts.shape[:2], cin, generator=gen, device=dev)
        nx32 = group_points(pad_shadow_row(x), inds)
        w2d = torch.randn(m * cin, cout, generator=gen, device=dev) / (m * cin) ** 0.5
        yield name, pts.shape[0] * pts.shape[1], cin, cout, rel, nx32, kp, w2d, extent


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cycles", action="store_true", help="count the forward's cycles per phase")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kpconv_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = _build.library(defines=("MVKP_CYCLES",) if args.cycles else ())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    counts = (ctypes.c_ulonglong * 6)()
    for name, queries, cin, cout, rel, nx32, kp, w2d, extent in sites(dev):
        row = {"site": name, "queries": queries, "cin": cin, "cout": cout, "card": smi}
        if args.cycles:
            nx = nx32.to(torch.bfloat16)
            row["ms"] = _ms(lambda: k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent))
            for _ in range(2):  # the first read empties the counters, the second has one launch
                k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent)
                _build.check_launch("kpconv_fwd_cycles", lib.mvkp_kpconv_fwd_cycles(ctypes.addressof(counts)))
            sums, rows_wait, product_wait, product, block, n_blocks = list(counts)
            per_warp = n_blocks * FWD_WARPS
            row.update({"blocks": n_blocks, "block_cycles": block // n_blocks, "sums": sums // per_warp,
                        "sums_rows_wait": rows_wait // per_warp, "product_wait": product_wait // per_warp,
                        "product": product // per_warp})
            print(json.dumps(row), flush=True)
            continue
        m = kp.shape[0]
        infl = k4._influence(rel, kp, extent)
        for nx in (nx32.to(torch.bfloat16), nx32):
            dt = str(nx.dtype)[6:]
            lib.mvkp_kpconv_fwd_tune(0)
            want = k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent)
            times = {}
            for tq in VARIANTS:
                lib.mvkp_kpconv_fwd_tune(tq)
                got = k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent)
                assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), (name, tq)
                times["planned" if tq == 0 else f"{tq}q"] = _ms(lambda: k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent))
            lib.mvkp_kpconv_fwd_tune(0)
            w3 = w2d.reshape(m, cin, cout)
            infl_c = infl.to(nx.dtype)
            times["einsum_chain"] = _ms(lambda: blocks._contract(infl_c, nx, w3, nx.dtype))
            row[dt] = times
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
