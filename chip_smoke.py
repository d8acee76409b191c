"""Chip smoke test of the PyTorch / CUDA port (``mvkpconv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device: the card (``nvidia-smi`` name and power limit), torch's CUDA
     version and the ``nvcc`` version; exits non-zero without a card;
  2. build: compiles ``mvkpconv_tpu_torch/csrc/*.cu`` with nvcc (sm_90a), one
     ``nvcc -c`` per source in parallel, and lists ``ptxas``' registers and
     spills per kernel;
  3. k1_*: the radius top-k kernel against its plain PyTorch version at each
     of the 13 shapes one forward of the bench configuration launches (5
     conv, 4 pool, 4 upsample) and at k=100: indices equal, or differing only
     where the selected d² tie within 2⁻²⁰ relative; kernel and plain times
     (CUDA events, after a warm-up), their sum over the 13 calls
     (``k1_forward_sum``), and the time of the kernel this one replaced
     (``earlier_ms``); k1_adv_*, untimed, on inputs made to break a skip of
     supports by their boxes: shuffled points, supports at and around
     rounded d² = r² of a query in another group, a padded tail, Ns = 1000
     and Ns < k;
  4. k2_*: the pixel top-k kernel against its plain version at bench shapes
     (B=4, N=16384, V=5, 120×160, window 7, k=3), bf16 and f32 candidates;
  5. parity: the whole slice on the card (kernels) against the CPU (plain
     versions) at a small ARCHITECTURE_DEEPER configuration with the same
     weights, in f32 with TF32 off: max |Δ logit| ≤ 1e-4 · max |logit| on
     valid points;
  6. full: the slice at the bench configuration (B=4, N0=16384, 5 levels,
     K=30, 5 views of 120×160, width 128, bf16) with seeded random weights:
     finite logits of shape (4, 16384, 20), 13 radius top-k calls (26 device
     launches: each call a box pre-pass and the search) and 1 pixel top-k
     launch per forward, ms per forward and points/s;
  7. k3_*: the gather-VJP segment sum against its plain version at the
     bench configuration's level-0 gather sites (the pyramid's voxel-sorted
     indices, seeded normal rows, f32 and bf16): each element within
     2⁻¹⁸ · Σ|rows into its target| (the atomics add in an order that
     varies from run to run), the shadow row on its own; kernel and plain
     times;
  8. train_parity: 3 train steps on the card (kernels, gather VJP
     'banded') against the CPU (plain versions) from the same weights,
     f32, TF32 off, a batch without padded rows: each step's loss within
     1e-5 relative, every parameter after each step within rtol 1e-3, atol
     1e-5·(the largest |param| of the model); at the configuration of
     phase 5 each step starts from the CPU's state, at a 2-level one the
     two run free (see ``check_train_parity``);
  9. train_full: the train step at the bench configuration (bf16, gather
     VJP 'banded_bf16'): a warm-up step, then 5 timed steps; loss finite,
     parameters outside ``net_2d`` changed and ``net_2d`` unchanged bit for
     bit, one K3 launch per trunk gather whose features need a gradient
     (counted from the plan), ms per step, points/s and peak memory;
 10. k4_*: the fused KPConv kernels (forward, cotangent of the gathered
     features, weighted sums and the weight gradient built on them) against
     their plain versions at four conv sites of the bench pyramid (level-0
     ``simple`` 66→64 and ``resnetb`` 32→32, the first ``resnetb_strided``,
     the deepest ``resnetb`` 512→512), f32 and bf16 features: each element
     within 2⁻¹⁸ · Σ|terms| of the plain version, both judged against a
     float64 evaluation; with bf16 features the cotangent also as the main
     path takes it, written in bf16 by the kernel (the same allowance plus
     half a bf16 ulp); every kernel run twice and equal bit for bit; kernel,
     plain and einsum-chain times, each kernel's beside the time of the one
     it replaced (``earlier_ms``); the same checks without the times at one
     ``resnetb`` site of every level between; k4_shape_*: the three kernels,
     untimed, at shapes off the bench's (K up to 128, M up to 32, widths of 1,
     5, 31, 33, 40, 66, 70 channels, feature rows at 2-, 4- and 16-byte
     alignment);
 11. parity_fused: the forward on the card (K4) against the CPU (plain) with
     ``use_pallas_kpconv=True, influence_cache='none'`` at the configuration
     of phase 5, for early, middle and late fusion; train_parity_fused: the
     3 train steps of phase 8 with those flags;
 12. full_fused, train_full_fused: phases 6 and 9 on the fused path, with the
     K4 launch counts and the gather VJPs' row widths (3 + Cin at the conv
     gathers) from the plan, beside the default path's figures.

Then one JSON line with every kernel's figures (its time beside the least
time the card could take for the same bytes and operations), the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIE_REL = 2.0**-20  # a few float32 ulps
PARITY_REL = 1e-4
SEGSUM_REL = 2.0**-18  # of Σ|rows| into each target
KPCONV_REL = 2.0**-18  # of Σ|terms| of each output element
KPCONV_INFLUENCE_ABS = 2.0**-20  # of an influence weight (they lie in [0, 1])
BF16_HALF_ULP = 2.0**-8  # of a value: what rounding it to bf16 may move it by
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, outside the tensor cores
TRAIN_LOSS_REL = 1e-5
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL_REL = 1e-3, 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops):
    """The least ms the card could take: each input read once and each
    output written once at the memory rate, or the operations at the f32
    peak, whichever is larger; and which of the two."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def d2_gaps(d2_got, d2_want, r2=None):
    """(relative, absolute) largest gap between two selections' ascending d²
    lists; where one list has an entry and the other none (inf), the entry
    is compared with r²."""
    import torch

    if d2_got.numel() == 0:
        return 0.0, 0.0
    if r2 is not None:
        fill = torch.full_like(d2_got, r2)
        d2_got, d2_want = (
            torch.where(torch.isinf(d2_got) & torch.isfinite(d2_want), fill, d2_got),
            torch.where(torch.isinf(d2_want) & torch.isfinite(d2_got), fill, d2_want),
        )
    if torch.isinf(d2_got).ne(torch.isinf(d2_want)).any():
        return float("inf"), float("inf")
    both = torch.isfinite(d2_got)
    diff = torch.where(both, (d2_got - d2_want).abs(), torch.zeros_like(d2_got))
    rel = diff / torch.maximum(d2_got.abs(), d2_want.abs()).clamp(min=1e-30)
    return float(rel.max()), float(diff.max())


def pairs_within(query, support, r2):
    """How many (query, support) pairs of the same batch element lie within
    the squared radius, counted in slabs of queries."""
    total = 0
    for q0 in range(0, query.shape[1], 2048):
        diff = query[:, q0:q0 + 2048, None, :] - support[:, None, :, :]
        total += int(((diff * diff).sum(-1) <= r2).sum())
    return total


# Times of the kernels that the present K1 and K4 kernels replaced, ms, from
# this script on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md's kernel tables);
# bwd_x's were taken with an f32 result.
EARLIER_MS = {
    "k1_L0_conv": 3.126, "k1_L0_pool": 1.866, "k1_L0_upsample": 0.154, "k1_L3_conv": 0.106,
    "k1_L2_conv_k100": 1.372,
    "k4_L0_simple_float32": 1.621, "k4_L0_simple_bfloat16": 1.577,
    "k4_L0_resnetb_float32": 0.648, "k4_L0_resnetb_bfloat16": 0.501,
    "k4_L0_strided_float32": 0.171, "k4_L0_strided_bfloat16": 0.146,
    "k4_L4_resnetb_float32": 0.294, "k4_L4_resnetb_bfloat16": 0.275,
    "k4_L0_simple_float32_bwd_x": 2.024, "k4_L0_simple_bfloat16_bwd_x": 1.995,
    "k4_L0_resnetb_float32_bwd_x": 0.443, "k4_L0_resnetb_bfloat16_bwd_x": 0.445,
    "k4_L0_strided_float32_bwd_x": 0.119, "k4_L0_strided_bfloat16_bwd_x": 0.120,
    "k4_L4_resnetb_float32_bwd_x": 0.212, "k4_L4_resnetb_bfloat16_bwd_x": 0.219,
    "k4_L0_simple_float32_wf": 0.624, "k4_L0_simple_bfloat16_wf": 0.684,
    "k4_L0_resnetb_float32_wf": 0.297, "k4_L0_resnetb_bfloat16_wf": 0.373,
    "k4_L0_strided_float32_wf": 0.084, "k4_L0_strided_bfloat16_wf": 0.102,
    "k4_L4_resnetb_float32_wf": 0.074, "k4_L4_resnetb_bfloat16_wf": 0.071,
}
EARLIER_FROM = "the kernel before its redesign (PERF.md)"


def check_k1(name, query, support, radius, k, results, timed=True):
    """K1 against its plain version on one (query, support) pair: equal
    indices, or rows that differ only where the selected d² tie within 2⁻²⁰
    relative; with ``timed`` also the kernel's and the plain version's times
    and the bound."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1

    got = k1.radius_topk(query, support, radius, k)
    want = k1.radius_topk_plain(query, support, radius, k)
    torch.cuda.synchronize()
    ns = support.shape[1]
    s_pad = torch.cat([support, torch.full_like(support[:, :1], float("inf"))], dim=1)

    def d2(idx):
        nb = torch.gather(
            s_pad, 1, idx.long().reshape(idx.shape[0], -1, 1).expand(-1, -1, 3)
        ).reshape(*idx.shape, 3)
        diff = query[:, :, None, :] - nb
        return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]

    differ = (got != want).any(-1)
    gap, gap_abs = d2_gaps(d2(got)[differ], d2(want)[differ], k1.squared_radius(radius))
    assert got.shape == want.shape and got.dtype == torch.int32, name
    assert bool(((got >= 0) & (got <= ns)).all()), name
    assert gap <= TIE_REL, f"{name}: K1 disagrees with its plain version (d² gap {gap})"
    if not timed:
        row = {"phase": name, "nq": query.shape[1], "ns": ns, "b": query.shape[0], "k": k,
               "radius": radius, "rows_differ": int(differ.sum()), "max_d2_gap_rel": gap,
               "max_d2_gap": gap_abs, "found": int((got < ns).sum())}
        emit(row)
        results.append(row)
        return got
    ms = cuda_ms(lambda: k1.radius_topk(query, support, radius, k), reps=20)
    plain_ms = cuda_ms(lambda: k1.radius_topk_plain(query, support, radius, k), reps=3, warmup=1)
    in_radius = pairs_within(query, support, k1.squared_radius(radius))
    row = {
        "phase": name, "nq": query.shape[1], "ns": ns, "b": query.shape[0], "k": k,
        "radius": radius, "rows_differ": int(differ.sum()), "max_d2_gap_rel": gap, "max_d2_gap": gap_abs,
        "ms": ms, "plain_ms": plain_ms, "pairs_in_radius": in_radius,
        "pairs": query.shape[0] * query.shape[1] * ns,
        # the function needs a d² (8 operations) and a comparison only for
        # the pairs within the radius in this run's data: an exact search may
        # skip every other support by its box.
        **bound(nbytes(query, support, got), 9.0 * in_radius),
    }
    if name in EARLIER_MS:
        row.update({"earlier_ms": EARLIER_MS[name], "earlier_from": EARLIER_FROM})
    emit(row)
    results.append(row)
    return got


def forward_k1_calls(spec, levels):
    """(name, queries, supports, radius, k) of the 13 selections one pyramid
    makes, as ``build_pyramid`` makes them."""
    calls = []
    for l, (p, _) in enumerate(levels):
        calls.append((f"k1_L{l}_conv", p, p, spec.radius(l), spec.conv_k(l)))
        if l + 1 < len(levels):
            sub, rp = levels[l + 1][0], spec.pool_radius(l)
            calls.append((f"k1_L{l}_pool", sub, p, rp, spec.pool_k(l)))
            calls.append((f"k1_L{l}_upsample", p, sub, 2.0 * rp, 1))
    return calls


def check_k1_adversarial(p0, radius, k, results):
    """K1 on inputs made to break a skip of supports by their boxes, untimed:
    shuffled points; a support at rounded d² just under and exactly at r² of
    a query in another group; a padded tail; Ns that is no multiple of a
    group; Ns < k."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1

    dev = p0.device
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    b, n, _ = p0.shape
    perm = torch.stack([torch.randperm(n, generator=gen) for _ in range(b)]).to(dev)
    shuffled = torch.gather(p0, 1, perm[..., None].expand(b, n, 3)).contiguous()
    check_k1("k1_adv_shuffled", shuffled, shuffled, radius, k, results, timed=False)
    check_k1("k1_adv_shuffled_supports", p0, shuffled, radius, k, results, timed=False)

    # Boundary: supports far from the cloud, at x offsets around the radius
    # from queries at x = 0 that sit in other groups (the sorted cloud keeps its
    # order; the probes are appended, so their groups' boxes are their own).
    r = np.float32(radius)
    r2 = np.float32(k1.squared_radius(radius))
    base = np.array([0.0, 100.0, 0.0], np.float32)  # x = 0: the offsets below are exact
    offs = []
    for start in (r, np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(1))):
        d = start
        for _ in range(4):  # a few neighbours of the radius on either side
            offs.append(d)
            d = np.nextafter(d, np.float32(0))
    # the rounded d² of each probe, as the kernel forms it: (x_q − x_s)², y = z = 0
    probes_q = np.tile(base, (len(offs), 1))
    probes_q[:, 1] += np.arange(len(offs), dtype=np.float32) * 5.0  # probes do not see each other
    probes_s = probes_q.copy()
    probes_s[:, 0] = probes_q[:, 0] + np.asarray(offs, np.float32)
    dx = probes_q[:, 0] - probes_s[:, 0]
    d2 = (dx * dx).astype(np.float32)
    assert (d2 < r2).any() and (d2 >= r2).any() and len(probes_q) < 32, "probes do not straddle r²"
    # queries: the cloud then the probe queries; supports: the cloud, 40
    # far fillers (so the probe supports start a group of their own), then the
    # probe supports
    filler = np.tile(np.array([[-50.0, -50.0, -50.0]], np.float32), (40 + (-n - 40) % 32, 1))
    q_np = np.concatenate([p0[0].cpu().numpy(), probes_q])[None]
    s_np = np.concatenate([p0[0].cpu().numpy(), filler, probes_s])[None]
    q_t, s_t = torch.from_numpy(q_np).to(dev), torch.from_numpy(s_np).to(dev)
    got = check_k1("k1_adv_boundary", q_t, s_t, radius, k, results, timed=False)
    first = got[0, n:, 0].cpu().numpy()
    want_first = np.where(d2 < r2, n + len(filler) + np.arange(len(offs)), s_np.shape[1])
    assert (first == want_first).all(), f"k1_adv_boundary: probes at the radius: {first} != {want_first}"
    emit({"phase": "k1_adv_boundary_probes", "probes": len(offs), "within": int((d2 < r2).sum()),
          "exactly_at_r2": int((d2 == r2).sum()), "beyond": int((d2 > r2).sum())})

    # a padded tail: a few hundred rows at the shadow coordinate
    padded = p0.clone()
    padded[:, -300:] = 1e6
    got = check_k1("k1_adv_padded_tail", padded, padded, radius, k, results, timed=False)
    tail = got[:, -300:].cpu()
    assert bool((tail == torch.arange(n - 300, n - 300 + k, dtype=torch.int32)).all()), \
        "padded queries must select the first k padded supports"
    # Ns no multiple of the group size, and fewer supports than k
    some = p0[:, :3000].contiguous()
    check_k1("k1_adv_ns1000", some, p0[:, :1000].contiguous(), radius, k, results, timed=False)
    check_k1("k1_adv_ns_below_k", some, p0[:, :k - 7].contiguous(), 4 * radius, k, results, timed=False)
    check_k1("k1_adv_ns_below_k_k1", some, p0[:, 5:6].contiguous(), 40 * radius, 1, results, timed=False)


def check_k2(name, points, image_xyz, iu0, iv0, window, k, results):
    import torch
    from mvkpconv_tpu_torch.ops.kernels import pixel_select as k2

    got = k2.pixel_topk(points, image_xyz, iu0, iv0, window, k)
    want = k2.pixel_topk_plain(points, image_xyz, iu0, iv0, window, k)
    torch.cuda.synchronize()
    b = points.shape[0]
    flat = image_xyz.reshape(b, -1, 3).float()

    def d2(idx):
        c = torch.gather(flat, 1, idx.long().reshape(b, -1, 1).expand(-1, -1, 3)).reshape(*idx.shape, 3)
        diff = c - points[:, :, None, :]
        return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]

    differ = (got != want).any(-1)
    gap, gap_abs = d2_gaps(d2(got)[differ], d2(want)[differ])
    assert got.shape == want.shape and got.dtype == torch.int32, name
    assert bool(((got >= 0) & (got < flat.shape[1])).all()), name
    assert gap <= TIE_REL, f"{name}: K2 disagrees with its plain version (d² gap {gap})"
    ms = cuda_ms(lambda: k2.pixel_topk(points, image_xyz, iu0, iv0, window, k), reps=20)
    plain_ms = cuda_ms(lambda: k2.pixel_topk_plain(points, image_xyz, iu0, iv0, window, k), reps=5, warmup=1)
    row = {
        "phase": name, "b": b, "n": points.shape[1], "views": image_xyz.shape[1],
        "hw": list(image_xyz.shape[2:4]), "window": window, "k": k,
        "dtype": str(image_xyz.dtype).replace("torch.", ""),
        "rows_differ": int(differ.sum()), "max_d2_gap_rel": gap, "max_d2_gap": gap_abs,
        "ms": ms, "plain_ms": plain_ms,
        # a d² and a comparison for every pixel of every view's window
        **bound(nbytes(points, image_xyz, iu0, iv0, got),
                9.0 * b * points.shape[1] * image_xyz.shape[1] * window * window),
    }
    emit(row)
    results.append(row)


def check_k3(name, index, ns, c, gen, results):
    """K3 against its plain version on one gather site, f32 and bf16 rows.

    The atomics add in an order that varies from run to run, and two orders
    of n f32 terms differ by at most 2(n − 1)·2⁻²⁴·Σ|terms|. So each output
    element is held to 2⁻¹⁸·Σ|rows into its target| (the plain version on
    |rows|): a bound for targets of up to 33 rows, about the neighbor lists'
    length, and far above the usual error of the shadow row's thousands. A
    kernel that rounded rows to bf16 (2⁻⁹) or dropped one would exceed it
    at every site. The shadow row, which the kernel sums per block, is
    reported on its own."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import segsum as k3

    rows32 = torch.randn(index.numel(), c, generator=gen, device=index.device)
    for rows in (rows32, rows32.to(torch.bfloat16)):
        got = k3.segsum(rows, index, ns)
        want = k3.segsum_plain(rows, index, ns)
        allowance = SEGSUM_REL * k3.segsum_plain(rows.abs(), index, ns) + 1e-30
        over = (got - want).abs() / allowance
        targets, shadow = float(over[:, :-1].max()), float(over[:, -1].max())
        err = float((got - want).abs().max())
        assert got.shape == want.shape and got.dtype == torch.float32, name
        assert targets <= 1.0, f"{name}: K3 disagrees with its plain version ({targets} × the allowance)"
        assert shadow <= 1.0, f"{name}: K3's shadow row disagrees with its plain version ({shadow} × the allowance)"
        row = {
            "phase": f"{name}_{str(rows.dtype)[6:]}", "b": index.shape[0], "nq": index.shape[1],
            "k": index.shape[2], "ns": ns, "c": c, "dtype": str(rows.dtype)[6:],
            "shadow_rows": int((index == ns - 1).sum()), "max_abs_err": err,
            "err_over_allowance": targets, "shadow_err_over_allowance": shadow,
            "ms": cuda_ms(lambda: k3.segsum(rows, index, ns), reps=20),
            "plain_ms": cuda_ms(lambda: k3.segsum_plain(rows, index, ns), reps=20),
            # one add per row element; the plain version is the one PyTorch
            # call for this function (index_add_)
            **bound(nbytes(rows, index, got), float(rows.numel())),
        }
        row["library_ms"] = row["plain_ms"]
        emit(row)
        results.append(row)


def check_k4(name, q_pts, q_mask, s_pts, inds, cin, cout, radius, cfg, gen, results, timed=True):
    """The three K4 kernels against their plain versions at one conv site of
    the pyramid, f32 and bf16 features; with ``timed`` also their times.

    Kernel and plain version add the same f32 terms in different orders (the
    plain version through PyTorch's batched and plain matrix products), and
    their influences may differ in the last bit, so each output element is
    held to 2⁻¹⁸ · Σ|terms| (the plain version on |features|, |weights|,
    |cotangent|): 64 units of f32 rounding, far below a bf16 (2⁻⁹) or TF32
    (2⁻¹¹) product. An influence is 1 − d/extent, so it carries an absolute
    error of a few 2⁻²⁴ whatever its size, and one version may give 0 where
    the other gives 1e-7: the allowance adds 2⁻²⁰ · Σ|terms with every
    influence set to 1|. Both are also judged against the plain version in
    float64.
    The weight gradient sums over all B·N queries in one matrix product on
    the kernel's ``wf``; it is held the same way. A shadow neighbor of a
    valid query gets a cotangent of exactly 0 (a padded query sits on its
    shadow neighbors, which is the influence-1 case). With bf16 features the
    cotangent is also taken as the main path takes it, written in bf16 by the
    kernel: held against the plain version's f32 result within the same
    allowance plus half a bf16 ulp of the value. All three kernels run twice
    and give the same bits."""
    import torch
    from mvkpconv_tpu_torch.models import blocks
    from mvkpconv_tpu_torch.models.kernel_points import kernel_point_positions
    from mvkpconv_tpu_torch.ops.gather import group_points, pad_shadow_row
    from mvkpconv_tpu_torch.ops.kernels import kpconv as k4

    dev = q_pts.device
    m = cfg.num_kernel_points
    extent = radius * cfg.kp_extent / cfg.conv_radius
    kp = torch.from_numpy(kernel_point_positions(radius, m)).to(dev)
    s_pad = torch.cat([s_pts, torch.full_like(s_pts[:, :1], 1e6)], dim=1)
    rel = (group_points(s_pad, inds) - q_pts[:, :, None, :]).contiguous()
    x = torch.randn(*s_pts.shape[:2], cin, generator=gen, device=dev)
    nx32 = group_points(pad_shadow_row(x), inds)
    w2d = torch.randn(m * cin, cout, generator=gen, device=dev) / (m * cin) ** 0.5
    g = torch.randn(*q_pts.shape[:2], cout, generator=gen, device=dev)
    b, n, k = inds.shape
    q = b * n
    infl = k4._influence(rel, kp, extent)
    nnz = float((infl > 0).sum())
    infl_ops = 12.0 * q * k * m  # 3 differences, their squares' sum, sqrt, divide, 1 − ·, max
    rel64, kp64, w64, g64 = rel.double(), kp.double(), w2d.double(), g.double()

    def over(got, want, allowance):
        return float(((got - want).abs() / (allowance + 1e-30)).max())

    shadow = (inds == s_pts.shape[1]) & q_mask[:, :, None]

    for nx in (nx32, nx32.to(torch.bfloat16)):
        dt = str(nx.dtype)[6:]
        a_nx, a_w, a_g = nx.float().abs(), w2d.abs(), g.abs()
        ones_wf = KPCONV_INFLUENCE_ABS * a_nx.sum(2).repeat(1, 1, m)  # (B, N, M·Cin)
        checks = {}
        # forward
        got = k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent)
        want = k4.kpconv_fused_plain(rel, nx, kp, w2d, extent)
        ref = k4.kpconv_fused_plain(rel64, nx.double(), kp64, w64, extent)
        allow = KPCONV_REL * k4.kpconv_fused_plain(rel, a_nx, kp, a_w, extent) + torch.matmul(ones_wf, a_w)
        assert got.shape == (b, n, cout) and got.dtype == torch.float32, name
        again = k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent)
        assert torch.equal(got, again), f"{name} {dt}: K4's forward differs from run to run"
        checks["fwd"] = (over(got, want, allow), over(got, ref, allow), over(want, ref, allow),
                         float((got - want).abs().max()))
        # the cotangent of the gathered features
        got = k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent)
        want = k4.kpconv_fused_bwd_x_plain(rel, g, kp, w2d, extent)
        ref = k4.kpconv_fused_bwd_x_plain(rel64, g64, kp64, w64, extent)
        allow = KPCONV_REL * k4.kpconv_fused_bwd_x_plain(rel, a_g, kp, a_w, extent) + (
            KPCONV_INFLUENCE_ABS * torch.matmul(a_g, a_w.t()).reshape(b, n, m, cin).sum(2)[:, :, None, :])
        assert got.shape == (b, n, k, cin) and got.dtype == torch.float32, name
        assert bool((got[shadow] == 0).all()), f"{name}: shadow neighbors got a cotangent"
        again = k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent)
        assert torch.equal(got, again), f"{name} {dt}: K4's bwd_x differs from run to run"
        checks["bwd_x"] = (over(got, want, allow), over(got, ref, allow), over(want, ref, allow),
                           float((got - want).abs().max()))
        if nx.dtype == torch.bfloat16:
            got = k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, out_dtype=nx.dtype)
            assert got.shape == (b, n, k, cin) and got.dtype == nx.dtype, name
            assert bool((got[shadow] == 0).all()), f"{name}: shadow neighbors got a bf16 cotangent"
            assert torch.equal(got, k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, out_dtype=nx.dtype)), \
                f"{name}: K4's bf16 bwd_x differs from run to run"
            got = got.float()
            checks["bwd_x_bf16_out"] = (
                over(got, want, allow + BF16_HALF_ULP * want.abs()),
                over(got, ref, allow + BF16_HALF_ULP * ref.abs().float()),
                over(want.to(nx.dtype).float(), ref, allow + BF16_HALF_ULP * ref.abs().float()),
                float((got - want).abs().max()))
        # the weighted sums, and the weight gradient built on them
        got = k4.kpconv_wf(rel, nx, kp, extent)
        want = k4.kpconv_wf_plain(rel, nx, kp, extent)
        ref = k4.kpconv_wf_plain(rel64, nx.double(), kp64, extent)
        a_wf = k4.kpconv_wf_plain(rel, a_nx, kp, extent)
        allow = KPCONV_REL * a_wf + ones_wf
        assert got.shape == (b, n, m * cin) and got.dtype == torch.float32, name
        assert torch.equal(got, k4.kpconv_wf(rel, nx, kp, extent)), f"{name} {dt}: K4's wf differs from run to run"
        checks["wf"] = (over(got, want, allow), over(got, ref, allow), over(want, ref, allow),
                        float((got - want).abs().max()))
        allow = torch.matmul((KPCONV_REL * a_wf + ones_wf).reshape(q, -1).t(), a_g.reshape(q, -1))
        dw_want = torch.matmul(want.reshape(q, -1).t(), g.reshape(q, -1))
        dw_ref = torch.matmul(ref.reshape(q, -1).t(), g64.reshape(q, -1))
        del got, want, ref, a_wf, again
        dw = k4.weight_gradient(rel, nx, kp, g, extent)
        checks["dw"] = (over(dw, dw_want, allow), over(dw, dw_ref, allow), over(dw_want, dw_ref, allow),
                        float((dw - dw_want).abs().max()))
        for what, (vs_plain, vs_f64, plain_vs_f64, _) in checks.items():
            assert vs_plain <= 1.0, f"{name} {dt}: K4 {what} disagrees with its plain version ({vs_plain} × the allowance)"
            assert vs_f64 <= 1.0, f"{name} {dt}: K4 {what} is {vs_f64} × the allowance from float64"
        row = {
            "phase": f"{name}_{dt}", "b": b, "n": n, "k": k, "m": m, "cin": cin, "cout": cout,
            "dtype": dt, "influence_nonzero_share": nnz / (q * k * m),
            "shadow_neighbors": int(shadow.sum()), "padded_queries": int((~q_mask).sum()),
            **{f"{what}_err_over_allowance": v[0] for what, v in checks.items()},
            **{f"{what}_err_vs_f64_over_allowance": v[1] for what, v in checks.items()},
            **{f"{what}_plain_vs_f64_over_allowance": v[2] for what, v in checks.items()},
            **{f"{what}_max_abs_err": v[3] for what, v in checks.items()},
        }
        results.append(row)
        if not timed:
            emit(row)
            continue

        # times: kernels, plain versions, and the einsum chain on a prebuilt influence
        infl_c = infl.to(nx.dtype)
        w3 = w2d.reshape(m, cin, cout)
        nx_leaf = nx.clone().requires_grad_(True)
        w_leaf = w2d.clone().requires_grad_(True)
        w3_leaf = w3.clone().requires_grad_(True)

        def k4_fwd_bwd():
            out = k4.kpconv_fused(rel, nx_leaf, kp, w_leaf, extent)
            torch.autograd.grad(out, (nx_leaf, w_leaf), g)

        def chain_fwd_bwd():
            out = blocks._contract(infl_c, nx_leaf, w3_leaf, nx.dtype)
            torch.autograd.grad(out, (nx_leaf, w3_leaf), g)

        reps = 10
        fwd_in = nbytes(rel, nx, kp, w2d)
        row.update({
            "fwd": {
                "ms": cuda_ms(lambda: k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent), reps),
                "plain_ms": cuda_ms(lambda: k4.kpconv_fused_plain(rel, nx, kp, w2d, extent), reps),
                "einsum_chain_ms": cuda_ms(lambda: blocks._contract(infl_c, nx, w3, nx.dtype), reps),
                **bound(fwd_in + 4 * q * cout, infl_ops + 2 * nnz * cin + 2.0 * q * m * cin * cout),
                "earlier_ms": EARLIER_MS.get(f"{name}_{dt}"), "earlier_from": EARLIER_FROM,
            },
            # the cotangent in the features' type, as the main path takes it
            "bwd_x": {
                "ms": cuda_ms(lambda: k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, nx.dtype), reps),
                "f32_out_ms": cuda_ms(lambda: k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent), reps),
                "plain_ms": cuda_ms(lambda: k4.kpconv_fused_bwd_x_plain(rel, g, kp, w2d, extent, nx.dtype), reps),
                "out_dtype": dt,
                **bound(nbytes(rel, g, kp, w2d) + nx.element_size() * q * k * cin,
                        infl_ops + 2 * nnz * cin + 2.0 * q * m * cin * cout),
                "earlier_ms": EARLIER_MS.get(f"{name}_{dt}_bwd_x"),
                "earlier_from": EARLIER_FROM + ", f32 result",
            },
            "wf": {
                "ms": cuda_ms(lambda: k4.kpconv_wf(rel, nx, kp, extent), reps),
                "plain_ms": cuda_ms(lambda: k4.kpconv_wf_plain(rel, nx, kp, extent), reps),
                **bound(nbytes(rel, nx, kp) + 4 * q * m * cin, infl_ops + 2 * nnz * cin),
                "earlier_ms": EARLIER_MS.get(f"{name}_{dt}_wf"), "earlier_from": EARLIER_FROM,
            },
            "dw_ms": cuda_ms(lambda: k4.weight_gradient(rel, nx, kp, g, extent), reps),
            "fwd_bwd_ms": cuda_ms(k4_fwd_bwd, reps),
            "einsum_chain_fwd_bwd_ms": cuda_ms(chain_fwd_bwd, reps),
        })
        emit(row)


def check_k4_shapes(dev, gen, results):
    """K4's three kernels off the bench shapes, untimed, held like
    ``check_k4``: more than 16 kernel points and more than 16 or 32 neighbors
    (several tiles and halves of the per-query products), a single neighbor,
    kernel point and channel, widths that are no multiple of a chunk (with
    a last chunk of 1, 2, 6 and 8 channels, which ``wf`` folds into the pass
    before it), and feature rows at 16-, 4- and 2-byte alignment (a column
    slice of a wider tensor; the cotangent's rows are Cin wide, so its stores
    meet them too),
    with shadow neighbors and padded queries, f32 and bf16; the cotangent in
    the features' type."""
    import torch
    from mvkpconv_tpu_torch.ops.kernels import kpconv as k4

    shapes = [  # queries, K, M, Cin, Cout, columns before the features
        (1000, 40, 20, 5, 7, 0), (77, 128, 32, 70, 33, 0), (300, 1, 1, 1, 1, 0), (513, 30, 15, 66, 64, 3),
        (200, 33, 17, 32, 32, 0), (4096, 30, 15, 33, 40, 1), (129, 8, 16, 31, 65, 0), (64, 100, 15, 128, 128, 0),
        (150, 20, 15, 40, 24, 0),
    ]
    extent = 1.2
    for q, k, m, cin, cout, before in shapes:
        rel = torch.randn(1, q, k, 3, generator=gen, device=dev) * 0.6
        far = torch.rand(q, 1, 1, generator=gen, device=dev) < 0.2
        rel[0, :, k // 2:] += far * 1e6  # shadow neighbors
        rel[0, ::7] = 0.0  # padded queries: every neighbor on the centre kernel point
        shadow = rel[..., 0] > 1e5
        kp = torch.randn(m, 3, generator=gen, device=dev) * 0.5
        kp[0] = 0.0
        w2d = torch.randn(m * cin, cout, generator=gen, device=dev) / (m * cin) ** 0.5
        wide = torch.randn(1, q, k, before + cin, generator=gen, device=dev)
        g = torch.randn(1, q, cout, generator=gen, device=dev)
        rel64, kp64, w64, a_w, a_g = rel.double(), kp.double(), w2d.double(), w2d.abs(), g.abs()
        for dt in (torch.float32, torch.bfloat16):
            nx = wide.to(dt)[..., before:]
            a_nx = nx.float().abs()
            ones_wf = KPCONV_INFLUENCE_ABS * a_nx.sum(2).repeat(1, 1, m)
            name = f"k4_shape_q{q}_k{k}_m{m}_{cin}to{cout}_ld{before + cin}_{str(dt)[6:]}"
            row = {"phase": name}
            runs = {
                "fwd": (lambda: k4.kpconv_fused_fwd(rel, nx, kp, w2d, extent),
                        k4.kpconv_fused_plain(rel, nx, kp, w2d, extent),
                        k4.kpconv_fused_plain(rel64, nx.double(), kp64, w64, extent),
                        KPCONV_REL * k4.kpconv_fused_plain(rel, a_nx, kp, a_w, extent) + torch.matmul(ones_wf, a_w)),
                "bwd_x": (lambda: k4.kpconv_fused_bwd_x(rel, g, kp, w2d, extent, out_dtype=dt),
                          k4.kpconv_fused_bwd_x_plain(rel, g, kp, w2d, extent),
                          k4.kpconv_fused_bwd_x_plain(rel64, g.double(), kp64, w64, extent),
                          KPCONV_REL * k4.kpconv_fused_bwd_x_plain(rel, a_g, kp, a_w, extent) + (
                              KPCONV_INFLUENCE_ABS
                              * torch.matmul(a_g, a_w.t()).reshape(1, q, m, cin).sum(2)[:, :, None, :])),
                "wf": (lambda: k4.kpconv_wf(rel, nx, kp, extent),
                       k4.kpconv_wf_plain(rel, nx, kp, extent),
                       k4.kpconv_wf_plain(rel64, nx.double(), kp64, extent),
                       KPCONV_REL * k4.kpconv_wf_plain(rel, a_nx, kp, extent) + ones_wf),
            }
            for part, (run, want, ref, allow) in runs.items():
                got = run()
                assert torch.equal(got, run()), f"{name}: {part} differs from run to run"
                if part == "bwd_x":
                    assert got.dtype == dt and bool((got[shadow] == 0).all()), f"{name}: shadow cotangent"
                    if dt == torch.bfloat16:  # the f32 sum rounded once
                        allow = allow + BF16_HALF_ULP * want.abs()
                got = got.float()
                allow = allow + 1e-30
                vs_plain = float(((got - want).abs() / allow).max())
                vs_f64 = float(((got - ref).abs() / allow).max())
                assert bool(torch.isfinite(got).all()) and vs_plain <= 1.0 and vs_f64 <= 1.0, \
                    (name, part, vs_plain, vs_f64)
                # a bf16 cotangent's distance is its rounding's: kept apart from the f32 sums'
                key = "bwd_x_bf16_out" if part == "bwd_x" and dt == torch.bfloat16 else part
                row.update({f"{key}_err_over_allowance": vs_plain, f"{key}_err_vs_f64_over_allowance": vs_f64,
                            f"{key}_max_abs_err": float((got - want).abs().max())})
            emit(row)
            results.append(row)


def trunk_gathers(model):
    """Gathers of the trunk whose features need a gradient, from the plan:
    every conv block's neighbor gather, the max-pool shortcut of each
    strided block, each upsample and max-pool block. Early fusion's first
    block takes the lifted 2D features, so every one of them needs it; an
    encoder fed the batch's own features (see ``conv_blocks``) does not
    differentiate its first gather."""
    n = conv_blocks(model)[1] - conv_blocks(model)[0]
    for part in (*model.encoders, model.decoder):
        for name, *_ in part.plan:
            if "simple" in name or "resnetb" in name:
                n += 2 if "strided" in name else 1
            elif "upsample" in name or "pool" in name:
                n += 1
    return n


def gather_vjp_widths(model, fused):
    """Row widths of the trunk's gather VJPs, one per K3 launch, from the
    plan: a conv block gathers its KPConv's input features (a resnetb block
    its bottleneck, a quarter of the block's width), on the fused path
    jointly with the 3 position columns; a strided block's shortcut and an
    upsample or pool block gather their input as it is."""
    widths = []
    for part in (*model.encoders, model.decoder):
        for name, in_dim, out_dim, *_ in part.plan:
            if "simple" in name or "resnetb" in name:
                widths.append((in_dim if "simple" in name else out_dim // 4) + (3 if fused else 0))
                if "strided" in name:
                    widths.append(in_dim)
            elif "upsample" in name or "pool" in name:
                widths.append(in_dim)
    return sorted(widths)


def conv_blocks(model):
    """(KPConv blocks of the trunk, those whose input features need a
    gradient) from the plan. The fused path launches one K4 forward and one
    ``wf`` per block, and one ``bwd_x`` per block whose input needs a
    gradient: every block but the first of an encoder that is fed the batch's
    own features (middle fusion's 3D stream, late fusion's only one; early
    fusion's first block takes the lifted features, which do)."""
    is_conv = lambda name: "simple" in name or "resnetb" in name  # noqa: E731
    total = sum(is_conv(e[0]) for part in (*model.encoders, model.decoder) for e in part.plan)
    fed_raw = {"early": 0, "middle": 1, "late": 1}[model.cfg.fusion]
    first_is_conv = is_conv(model.encoders[0].plan[0][0])
    return total, total - (fed_raw if first_is_conv else 0)


def check_train_parity(phase, label, cfg, dev, resumed):
    """3 train steps on the card (kernels, gather VJP 'banded') against the
    CPU (plain versions) from the same weights, f32: each step's loss within
    1e-5 relative, every parameter after each step within rtol 1e-3, atol
    1e-5·(the largest |param|). With ``resumed`` the card takes the CPU's
    parameters, batch statistics and momentum before each step, so every
    step starts from one state; otherwise the two run free.

    The batch has no padded rows: a padded point's pixel-relation feature
    (~3e12) makes FeatureAggregation's unmasked BN statistics follow
    rounding (ROADMAP queue 3). At 5 levels the deep levels hold so few
    points that one leaky-ReLU input changing sign moves a gradient by
    percents, so free-running states part after the first step by more
    than rounding (tests/test_torch_train_deeper.py shows it on the CPU):
    that configuration is held step by step."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import batch_to_device
    from mvkpconv_tpu_torch.train import make_trainer, train_steps

    cfg = cfg.replace(gather_transpose="banded")
    cpu_tr = make_trainer(cfg, "cpu", seed=1)
    gpu_tr = make_trainer(cfg, dev, seed=2)
    gpu_tr.model.load_state_dict(cpu_tr.model.state_dict())
    tb = make_batch(cfg, 2, np.random.RandomState(1))
    cpu_b, gpu_b = batch_to_device(tb, "cpu"), batch_to_device(tb, dev)
    reset_launches()
    for step in (1, 2, 3):
        if resumed:
            gpu_tr.model.load_state_dict(cpu_tr.model.state_dict())
            gpu_tr.optimizer.load_state_dict(copy.deepcopy(cpu_tr.optimizer.state_dict()))
        want = float(train_steps(cpu_tr, cpu_b, 1)[0]["loss"])
        got = float(train_steps(gpu_tr, gpu_b, 1)[0]["loss"])
        loss_rel = abs(got - want) / abs(want)
        params = [(name, p.detach(), q.detach().cpu()) for (name, p), q in
                  zip(cpu_tr.model.named_parameters(), gpu_tr.model.parameters())]
        atol = TRAIN_PARAM_ATOL_REL * max(float(p.abs().max()) for _, p, _ in params)
        over = {name: float(((q - p).abs() / (TRAIN_PARAM_RTOL * p.abs() + atol)).max())
                for name, p, q in params}
        worst = max(over, key=over.get)
        emit({"phase": phase, "config": f"{label}, f32, banded",
              "start": "the CPU's state" if resumed else "free-running", "step": step,
              "loss_card": got, "loss_cpu": want, "loss_rel_err": loss_rel,
              "param_err_over_allowance": over[worst], "worst_param": worst,
              "params_outside": sum(r > 1.0 for r in over.values()), "params": len(over),
              "launches": read_launches()})
        assert np.isfinite(got) and loss_rel <= TRAIN_LOSS_REL, "card/CPU train loss disagree"
        assert over[worst] <= 1.0, "card/CPU parameters disagree"
    launches = read_launches()
    n_conv, n_bwd_x = conv_blocks(gpu_tr.model)
    assert launches["segsum"] == 3 * trunk_gathers(gpu_tr.model), launches
    assert launches["kpconv_fused_fwd"] == launches["kpconv_wf"] == (3 * n_conv if runs_k4(cfg) else 0), launches
    assert launches["kpconv_fused_bwd_x"] == (3 * n_bwd_x if runs_k4(cfg) else 0), launches


def check_forward_parity(phase, label, cfg, dev):
    """The forward on the card (kernels) against the CPU (plain versions)
    from the same weights, f32, TF32 off, on a batch with padded rows:
    max |Δ logit| ≤ 1e-4 · max |logit| on valid points."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import batch_to_device, infer, make_model
    from mvkpconv_tpu_torch.ops.kernels import kpconv as k4

    cpu_model = make_model(cfg, "cpu", seed=1)
    gpu_model = make_model(cfg, dev, seed=2)
    gpu_model.load_state_dict(cpu_model.state_dict())
    sb = make_batch(cfg, 2, np.random.RandomState(1))
    sb["mask"][-1, -24:] = False
    sb["points"] = np.where(sb["mask"][..., None], sb["points"], np.float32(1e6))
    want = infer(cpu_model, batch_to_device(sb, "cpu"))
    k4.kpconv_fused_fwd.launches = 0
    got = infer(gpu_model, batch_to_device(sb, dev)).cpu()
    mask = torch.from_numpy(sb["mask"])
    err = float((got - want).abs()[mask].max())
    scale = float(want.abs()[mask].max())
    emit({"phase": phase, "config": label, "max_abs_err": err, "max_abs_logit": scale,
          "limit": PARITY_REL * scale, "k4_fwd_launches": k4.kpconv_fused_fwd.launches})
    assert bool(torch.isfinite(got).all()) and err <= PARITY_REL * scale, "card/CPU logits disagree"
    assert k4.kpconv_fused_fwd.launches == (conv_blocks(gpu_model)[0] if runs_k4(cfg) else 0)


def runs_k4(cfg):
    """Whether the configuration's conv blocks reach the fused kernel: the
    flag, and no influence cache (a cache that exists wins)."""
    return bool(cfg.use_pallas_kpconv) and cfg.influence_cache == "none"


def kernel_counters():
    from mvkpconv_tpu_torch.ops.kernels import kpconv as k4
    from mvkpconv_tpu_torch.ops.kernels import pixel_select as k2
    from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1
    from mvkpconv_tpu_torch.ops.kernels import segsum as k3

    return {"radius_topk": k1.radius_topk, "pixel_topk": k2.pixel_topk, "segsum": k3.segsum,
            "kpconv_fused_fwd": k4.kpconv_fused_fwd, "kpconv_fused_bwd_x": k4.kpconv_fused_bwd_x,
            "kpconv_wf": k4.kpconv_wf}


def reset_launches():
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    counters["radius_topk"].device_launches = 0


def read_launches():
    """Each wrapper's count of calls that launched its kernel; K1 makes two
    device launches a call (the box pre-pass and the search), counted too."""
    counters = kernel_counters()
    return {**{name: fn.launches for name, fn in counters.items()},
            "radius_topk_device": counters["radius_topk"].device_launches}


def run_full(phase, cfg, dev, batch, smi, beside=None, forwards=5):
    """The inference slice at full width: a warm-up, then ``forwards`` timed
    forwards with every kernel's launches counted and held to the plan."""
    import torch
    from mvkpconv_tpu_torch.infer import infer, make_model

    model = make_model(cfg, dev, seed=0)
    logits = infer(model, batch)  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(forwards):
        logits = infer(model, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / forwards
    launches = read_launches()
    n_conv, _ = conv_blocks(model)
    assert tuple(logits.shape) == (cfg.batch_num, cfg.num_points[0], cfg.num_classes), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert launches["radius_topk"] == 13 * forwards, launches
    assert launches["radius_topk_device"] == 26 * forwards, launches
    assert launches["pixel_topk"] == forwards, launches
    assert launches["kpconv_fused_fwd"] == (n_conv * forwards if runs_k4(cfg) else 0), (launches, n_conv)
    assert launches["segsum"] == launches["kpconv_fused_bwd_x"] == launches["kpconv_wf"] == 0, launches
    row = {
        "phase": phase,
        "config": "bench.py:106-117 (B=4, N0=16384, K=30, V=5, 120x160, width 128, bf16)"
                  + (", use_pallas_kpconv=True, influence_cache='none'" if runs_k4(cfg) else ""),
        "forwards": forwards, "ms_per_forward": dt * 1e3,
        "points_per_s": cfg.batch_num * cfg.num_points[0] / dt, "launches": launches,
        "conv_blocks": n_conv,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "logit_abs_max": float(logits.abs().max()), "card": smi,
    }
    if beside is not None:
        row["default_path"] = {k: beside[k] for k in ("ms_per_forward", "points_per_s", "peak_mem_gib")}
    emit(row)
    return row, launches


def run_train_full(phase, cfg, dev, batch, smi, beside=None, steps=5):
    """The train step at full width: a warm-up step, then ``steps`` timed
    steps; loss finite, every trainable tensor moved, ``net_2d`` unchanged bit
    for bit, every kernel's launches held to the plan."""
    import numpy as np
    import torch
    from mvkpconv_tpu_torch.ops import gather
    from mvkpconv_tpu_torch.train import make_trainer, train_steps

    trainer = make_trainer(cfg, dev, seed=0)
    frozen = {k: v.clone() for k, v in trainer.model.net_2d.state_dict().items()}
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if not n.startswith("net_2d.")}
    train_steps(trainer, batch, 1)  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    metrics = train_steps(trainer, batch, steps)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = read_launches()
    # one more step, untimed, with the gather VJP's row widths written down
    segsum, seen = gather.segsum, []
    gather.segsum = lambda rows, index, ns: seen.append(rows.shape[1]) or segsum(rows, index, ns)
    try:
        train_steps(trainer, batch, 1)
    finally:
        gather.segsum = segsum
    losses = [float(m["loss"]) for m in metrics]
    n_gathers = trunk_gathers(trainer.model)
    n_conv, n_bwd_x = conv_blocks(trainer.model)
    fused = runs_k4(cfg)
    changed = sum(not torch.equal(p.detach(), start[n]) for n, p in trainer.model.named_parameters()
                  if n in start)
    assert all(np.isfinite(losses)), losses
    assert all(torch.equal(v, frozen[k]) for k, v in trainer.model.net_2d.state_dict().items()), "net_2d moved"
    assert changed == len(start), f"{len(start) - changed} trainable parameters did not move"
    assert launches["segsum"] == n_gathers * steps, (launches, n_gathers)
    assert sorted(seen) == gather_vjp_widths(trainer.model, fused), (sorted(seen), fused)
    assert launches["radius_topk"] == 13 * steps and launches["pixel_topk"] == steps, launches
    assert launches["radius_topk_device"] == 26 * steps, launches
    assert launches["kpconv_fused_fwd"] == launches["kpconv_wf"] == (n_conv * steps if fused else 0), launches
    assert launches["kpconv_fused_bwd_x"] == (n_bwd_x * steps if fused else 0), (launches, n_bwd_x)
    row = {
        "phase": phase,
        "config": "bench.py:106-117 train step (B=4, N0=16384, K=30, V=5, 120x160, width 128, bf16, banded_bf16)"
                  + (", use_pallas_kpconv=True, influence_cache='none'" if fused else ""),
        "steps": steps, "ms_per_step": dt * 1e3, "points_per_s": cfg.batch_num * cfg.num_points[0] / dt,
        "losses": losses, "accuracy_last": float(metrics[-1]["accuracy"]), "launches": launches,
        "trunk_gathers_with_grad": n_gathers, "gather_vjp_row_widths": sorted(seen),
        "conv_blocks": n_conv, "conv_blocks_with_input_grad": n_bwd_x,
        "params_moved": changed,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "card": smi,
    }
    if beside is not None:
        row["default_path"] = {k: beside[k] for k in ("ms_per_step", "points_per_s", "peak_mem_gib")}
    emit(row)
    return row, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "mvkpconv_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing next to {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
    from mvkpconv_tpu_torch.infer import FUSED_OPTIONS, batch_to_device, bench_config, fused_config
    from mvkpconv_tpu_torch.models.kpfcnn import plan_architecture
    from mvkpconv_tpu_torch.ops import _build
    from mvkpconv_tpu_torch.ops.pyramid import build_pyramid
    from mvkpconv_tpu_torch.ops.sampling import grid_subsample
    from mvkpconv_tpu_torch.ops.unproject import project_to_views, unproject_depth, window_anchors
    from mvkpconv_tpu_torch.training.config import ARCHITECTURE_DEEPER, KPConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True)
    emit({
        "phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
        "torch_cuda": torch.version.cuda, "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    })

    # ---- build ----
    t0 = time.perf_counter()
    lib = _build.build()
    seconds = time.perf_counter() - t0
    _build.library()
    log = lib.with_suffix(".log").read_text().splitlines()
    emit({
        "phase": "build", "seconds": seconds, "library": lib.name,
        "ptxas": [ln.strip() for ln in log if "registers" in ln or "spill" in ln],
    })

    # ---- kernels against their plain versions at main-path shapes ----
    cfg = bench_config()
    spec = cfg.pyramid_spec()
    raw = make_batch(cfg, cfg.batch_num, np.random.RandomState(0))
    batch = batch_to_device(raw, dev)
    p0, m0 = batch["points"], batch["mask"]
    levels = [(p0, m0)]
    for l in range(1, spec.num_levels):
        sub = grid_subsample(levels[-1][0], spec.cell_size(l), spec.num_points[l], mask=levels[-1][1])
        levels.append((sub.points, sub.mask))
    k1_rows, k2_rows = [], []
    calls = forward_k1_calls(spec, levels)
    assert len(calls) == 13, len(calls)
    for call in calls:
        check_k1(*call, k1_rows)
    emit({"phase": "k1_forward_sum", "calls": len(calls),
          "ms": sum(r["ms"] for r in k1_rows), "plain_ms": sum(r["plain_ms"] for r in k1_rows),
          "bound_ms": sum(r["bound_ms"] for r in k1_rows),
          "earlier_ms_of": {n: EARLIER_MS[n] for n, *_ in calls if n in EARLIER_MS}})
    # off the main path: more supports within the radius (283 a query) than the list holds
    check_k1("k1_L2_conv_k100", levels[2][0], levels[2][0], spec.radius(2), 100, k1_rows)
    k1_adv_rows = []
    check_k1_adversarial(p0, spec.radius(0), spec.conv_k(0), k1_adv_rows)

    image_xyz, _ = unproject_depth(batch["depth"], batch["intrinsics"], batch["poses"])
    u, v = project_to_views(p0, batch["intrinsics"], batch["poses"])
    w = cfg.pixel_window
    iu0 = window_anchors(u, cfg.image_width, w).contiguous()
    iv0 = window_anchors(v, cfg.image_height, w).contiguous()
    for dt in (torch.bfloat16, torch.float32):
        check_k2(f"k2_{str(dt)[6:]}", p0, image_xyz.to(dt).contiguous(), iu0, iv0, w, cfg.pixel_knn, k2_rows)

    # ---- card against CPU on the same weights, f32 ----
    small = KPConfig(
        fusion="early", in_features_dim=66, architecture=ARCHITECTURE_DEEPER,
        num_points=(1024, 256, 64, 32, 16), conv_neighbors=(16,) * 5,
        pool_neighbors=(16,) * 4, first_features_dim=32, num_views=3,
        image_height=24, image_width=32,
    )
    small_label = "ARCHITECTURE_DEEPER, N0=1024, width 32, 3 views 24x32"
    check_forward_parity("parity", f"{small_label}, f32", small, dev)

    # ---- the slice at full width ----
    full_row, launches = run_full("full", cfg, dev, batch, smi)

    # ---- K3 and K4 at the conv sites of the bench pyramid ----
    pyr = build_pyramid(p0, m0, spec)
    enc, dec, _ = plan_architecture(cfg)
    n1 = pyr.points[1].shape[1]
    up_c = [e[1] for e in dec if "upsample" in e[0]][-1]  # the last upsample's width
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    k3_rows, k4_rows = [], []
    check_k3("k3_L0_simple", pyr.neighbors[0], cfg.num_points[0] + 1, enc[0][1], gen, k3_rows)
    check_k3("k3_L0_resnetb", pyr.neighbors[0], cfg.num_points[0] + 1, enc[1][2] // 4, gen, k3_rows)
    check_k3("k3_L0_strided", pyr.pools[0], cfg.num_points[0] + 1, enc[2][2] // 4, gen, k3_rows)
    check_k3("k3_L0_strided_maxpool", pyr.pools[0], cfg.num_points[0] + 1, enc[2][1], gen, k3_rows)
    check_k3("k3_L0_upsample", pyr.upsamples[0], n1 + 1, up_c, gen, k3_rows)
    top = len(pyr.points) - 1
    for name, q_l, s_l, inds, entry, cin, cout in (
        ("k4_L0_simple", 0, 0, pyr.neighbors[0], enc[0], enc[0][1], enc[0][2] // 2),
        ("k4_L0_resnetb", 0, 0, pyr.neighbors[0], enc[1], enc[1][2] // 4, enc[1][2] // 4),
        ("k4_L0_strided", 1, 0, pyr.pools[0], enc[2], enc[2][2] // 4, enc[2][2] // 4),
        (f"k4_L{top}_resnetb", top, top, pyr.neighbors[top], enc[-1], enc[-1][2] // 4, enc[-1][2] // 4),
    ):
        check_k4(name, pyr.points[q_l], pyr.masks[q_l], pyr.points[s_l], inds, cin, cout,
                 entry[3], cfg, gen, k4_rows)
    # the levels between, one ``resnetb`` site each, held but not timed
    for l in range(1, top):
        entry = next(e for e in enc if e[4] == l and e[0] == "resnetb")
        check_k4(f"k4_L{l}_resnetb", pyr.points[l], pyr.masks[l], pyr.points[l], pyr.neighbors[l],
                 entry[2] // 4, entry[2] // 4, entry[3], cfg, gen, k4_rows, timed=False)
    del pyr
    k4_shape_rows = []
    check_k4_shapes(dev, gen, k4_shape_rows)

    # ---- train step: card against CPU on the same weights, f32 ----
    two_level = KPConfig(
        fusion="early", in_features_dim=66,
        architecture=("simple", "resnetb", "resnetb_strided", "resnetb", "nearest_upsample", "unary"),
        num_points=(256, 64), conv_neighbors=(10, 10), pool_neighbors=(10,),
        first_features_dim=32, num_views=2, image_height=24, image_width=32,
    )
    check_train_parity("train_parity", small_label, small, dev, resumed=True)
    check_train_parity("train_parity", "6 blocks, 2 levels, N0=256, width 32, 2 views 24x32", two_level, dev, resumed=False)

    # ---- the train step at full width ----
    train_row, train_launches = run_train_full("train_full", cfg, dev, batch, smi)

    # ---- the fused KPConv path (K4): card against CPU, then full width ----
    for fusion in ("early", "middle", "late"):
        check_forward_parity("parity_fused", f"{small_label}, f32, fusion={fusion}, K4",
                             small.replace(fusion=fusion, **FUSED_OPTIONS), dev)
    check_train_parity("train_parity_fused", f"{small_label}, K4", small.replace(**FUSED_OPTIONS), dev, resumed=True)
    fused = fused_config()
    fused_row, fused_launches = run_full("full_fused", fused, dev, batch, smi, beside=full_row)
    fused_train_row, fused_train_launches = run_train_full("train_full_fused", fused, dev, batch, smi, beside=train_row)

    l0 = k1_rows[0]
    bf16 = k2_rows[0]
    k3_main = next(r for r in k3_rows if r["phase"] == "k3_L0_resnetb_bfloat16")
    k4_main = next(r for r in k4_rows if r["phase"] == "k4_L0_resnetb_bfloat16")

    def k4_entry(name, part, count):
        return {"name": name, "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/kpconv.cu",
                "replaces": "mvkpconv_tpu/ops/pallas/kpconv.py:135", "launches": count,
                "max_abs_err": max(r[f"{part}_max_abs_err"] for r in k4_rows + k4_shape_rows
                                   if f"{part}_max_abs_err" in r),
                "ms": k4_main[part]["ms"], "plain_ms": k4_main[part]["plain_ms"],
                "bound_ms": k4_main[part]["bound_ms"], "bound_by": k4_main[part]["bound_by"],
                "library_ms": None}

    emit({"kernels": [
        {"name": "radius_topk", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/radius_topk.cu",
         "replaces": "mvkpconv_tpu/ops/pallas/radius_topk.py:121",
         "launches": launches["radius_topk"],
         "device_launches": launches["radius_topk_device"],
         "max_abs_err": max(r["max_d2_gap"] for r in k1_rows + k1_adv_rows),
         "ms": l0["ms"], "plain_ms": l0["plain_ms"], "bound_ms": l0["bound_ms"],
         "bound_by": l0["bound_by"], "library_ms": None},
        {"name": "pixel_topk", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/pixel_select.cu",
         "replaces": "mvkpconv_tpu/ops/pallas/pixel_select.py:97",
         "launches": launches["pixel_topk"],
         "max_abs_err": max(r["max_d2_gap"] for r in k2_rows),
         "ms": bf16["ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
         "bound_by": bf16["bound_by"], "library_ms": None},
        {"name": "segsum", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/segsum.cu",
         "replaces": "mvkpconv_tpu/ops/pallas/segsum.py:284",
         "launches": train_launches["segsum"],
         "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"], "bound_ms": k3_main["bound_ms"],
         "bound_by": k3_main["bound_by"], "library_ms": k3_main["library_ms"]},
        {**k4_entry("kpconv_fused", "fwd", fused_launches["kpconv_fused_fwd"]),
         "einsum_chain_ms": k4_main["fwd"]["einsum_chain_ms"]},
        k4_entry("kpconv_fused_bwd_x", "bwd_x", fused_train_launches["kpconv_fused_bwd_x"]),
        k4_entry("kpconv_wf", "wf", fused_train_launches["kpconv_wf"]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
