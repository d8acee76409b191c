"""Times K4's kernels, or counts their cycles, at the conv sites of the bench pyramid.

    python3 -m mvkpconv_tpu_torch.tools.kpconv_variants [--bwd] [--cycles]

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

With ``--bwd`` it times the two backward kernels instead, ``bwd_x`` (the
cotangent of the features, written in the features' type) and ``wf`` (the
weighted sums), with ``mvkp_kpconv_bwd_tune`` forcing 64, 32 or 16 queries a
block of ``bwd_x`` and with them 4, 2 or 1 queries a warp of ``wf``; every
variant's result equals the planned one's bit for bit (the variants differ
in who computes an element, not in how).

With ``--cycles`` it builds the kernels with ``-DMVKP_CYCLES`` instead, which
makes them add up ``clock64`` differences at their phase boundaries (lane 0 of
every warp), and prints per site, for bf16 rows and the planned variant, under
``fwd``: ``ms`` of the instrumented kernel, its blocks, ``block_cycles`` (mean
cycles from a block's start to its end) and, as means per warp and block over
all chunks of channels, ``sums`` (phase 1, the per-query sums),
``sums_rows_wait`` (of it, waiting for the staged rows), ``product_wait``
(phase 2's waits for W and its barriers) and ``product`` (the rest of phase
2); under ``bwd_x``, per unit of work (a tile of queries and a chunk of
channels; a block takes several): ``stage_wait`` (phase A's waits for g, W
and its barriers), ``asking`` (issuing the ``cp.async`` copies of tiles and
offsets, in both phases), ``gw`` (the rest of phase A), ``dx`` (the rest of
phase B without its stores) and ``stores``; under ``wf``: the warps that had a query and, as means per
such warp, ``warp_cycles``, ``rows_wait`` and ``stores``. No profiler attaches
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


def _cycles(lib, name, n):
    """The named kernel's cycle counts since the last read."""
    counts = (ctypes.c_ulonglong * n)()
    _build.check_launch(name, getattr(lib, name)(ctypes.addressof(counts)))
    return list(counts)


def cycles_row(lib, rel, nx, g, kp, w2d, extent):
    """Cycles per phase of one launch of each K4 kernel (bf16 rows)."""
    runs = {
        "fwd": lambda: k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent),
        "bwd_x": lambda: k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, nx.dtype),
        "wf": lambda: k4.kpconv_wf(rel, nx, kp, extent),
    }
    row = {}
    for part, run in runs.items():
        ms = _ms(run)
        name, n = f"mvkp_kpconv_{part}_cycles", {"fwd": 6, "bwd_x": 7, "wf": 4}[part]
        _cycles(lib, name, n)  # empties the counters
        run()
        counts = _cycles(lib, name, n)
        if part == "wf":
            total, rows_wait, stores, warps = counts
            row[part] = {"ms": ms, "warps": warps, "warp_cycles": total // warps,
                         "rows_wait": rows_wait // warps, "stores": stores // warps}
            continue
        # the forward counts blocks; bwd_x, whose blocks stay on their SMs, the units
        # of work (TQ queries, one chunk of channels) they took
        names, unit = ((("sums", "sums_rows_wait", "product_wait", "product"), "blocks") if part == "fwd"
                       else (("stage_wait", "asking", "gw", "dx", "stores"), "units"))
        total, n_units = counts[len(names)], counts[len(names) + 1]
        row[part] = {"ms": ms, unit: n_units, unit[:-1] + "_cycles": total // n_units,
                     **{key: c // (n_units * FWD_WARPS) for key, c in zip(names, counts)}}
    return row


def bwd_row(lib, rel, nx, g, kp, w2d, extent):
    """ms of ``bwd_x`` and ``wf`` per forced variant, the planned one's first."""
    runs = {
        "bwd_x": lambda: k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, nx.dtype),
        "wf": lambda: k4.kpconv_wf(rel, nx, kp, extent),
    }
    row = {}
    for part, run in runs.items():
        lib.mvkp_kpconv_bwd_tune(0)
        want = run()
        times = {}
        for tq in VARIANTS:
            lib.mvkp_kpconv_bwd_tune(tq)
            assert torch.equal(run(), want), (part, tq)
            label = "planned" if tq == 0 else f"{tq}q" if part == "bwd_x" else f"{tq // 16}q_a_warp"
            times[label] = _ms(run)
        lib.mvkp_kpconv_bwd_tune(0)
        row[part] = times
    return row


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cycles", action="store_true", help="count the kernels' cycles per phase")
    parser.add_argument("--bwd", action="store_true", help="time bwd_x and wf instead of the forward")
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for name, queries, cin, cout, rel, nx32, kp, w2d, extent in sites(dev):
        row = {"site": name, "queries": queries, "cin": cin, "cout": cout, "card": smi}
        g = torch.randn(*rel.shape[:2], cout, generator=gen, device=dev)
        if args.cycles:
            row.update(cycles_row(lib, rel, nx32.to(torch.bfloat16), g, kp, w2d, extent))
            print(json.dumps(row), flush=True)
            continue
        if args.bwd:
            for nx in (nx32.to(torch.bfloat16), nx32):
                row[str(nx.dtype)[6:]] = bwd_row(lib, rel, nx, g, kp, w2d, extent)
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
