"""Chip smoke test of the PyTorch / CUDA port (``mvkpconv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device: the card (``nvidia-smi`` name and power limit), torch's CUDA
     version and the ``nvcc`` version; exits non-zero without a card;
  2. build: compiles ``mvkpconv_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
  3. k1_*: the radius top-k kernel against its plain PyTorch version at the
     main path's shapes of the bench configuration (level-0 conv, pool and
     upsample, one deep level) and at k=100: indices equal, or differing only where the
     selected d² tie within 2⁻²⁰ relative; kernel and plain times (CUDA
     events, after a warm-up);
  4. k2_*: the pixel top-k kernel against its plain version at bench shapes
     (B=4, N=16384, V=5, 120×160, window 7, k=3), bf16 and f32 candidates;
  5. parity: the whole slice on the card (kernels) against the CPU (plain
     versions) at a small ARCHITECTURE_DEEPER configuration with the same
     weights, in f32 with TF32 off: max |Δ logit| ≤ 1e-4 · max |logit| on
     valid points;
  6. full: the slice at the bench configuration (B=4, N0=16384, 5 levels,
     K=30, 5 views of 120×160, width 128, bf16) with seeded random weights:
     finite logits of shape (4, 16384, 20), 13 radius top-k launches and 1
     pixel top-k launch per forward, ms per forward and points/s.

Then one JSON line with every kernel's figures, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIE_REL = 2.0**-20  # a few float32 ulps
PARITY_REL = 1e-4


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


def check_k1(name, query, support, radius, k, results):
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
    ms = cuda_ms(lambda: k1.radius_topk(query, support, radius, k), reps=20)
    plain_ms = cuda_ms(lambda: k1.radius_topk_plain(query, support, radius, k), reps=3, warmup=1)
    row = {
        "phase": name, "nq": query.shape[1], "ns": ns, "b": query.shape[0], "k": k,
        "radius": radius, "rows_differ": int(differ.sum()), "max_d2_gap_rel": gap, "max_d2_gap": gap_abs,
        "ms": ms, "plain_ms": plain_ms,
    }
    emit(row)
    results.append(row)


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
    }
    emit(row)
    results.append(row)


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
    from mvkpconv_tpu_torch.infer import batch_to_device, bench_config, infer, make_model
    from mvkpconv_tpu_torch.ops import _build
    from mvkpconv_tpu_torch.ops.kernels import pixel_select as k2
    from mvkpconv_tpu_torch.ops.kernels import radius_topk as k1
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
    check_k1("k1_L0_conv", p0, p0, spec.radius(0), spec.conv_k(0), k1_rows)
    check_k1("k1_L0_pool", levels[1][0], p0, spec.pool_radius(0), spec.pool_k(0), k1_rows)
    check_k1("k1_L0_upsample", p0, levels[1][0], 2 * spec.pool_radius(0), 1, k1_rows)
    check_k1("k1_L3_conv", levels[3][0], levels[3][0], spec.radius(3), spec.conv_k(3), k1_rows)
    # off the main path: the widest list (k > 64, the instance that spills)
    check_k1("k1_L2_conv_k100", levels[2][0], levels[2][0], spec.radius(2), 100, k1_rows)

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
    cpu_model = make_model(small, "cpu", seed=1)
    gpu_model = make_model(small, dev, seed=2)
    gpu_model.load_state_dict(cpu_model.state_dict())
    sb = make_batch(small, 2, np.random.RandomState(1))
    sb["mask"][-1, -24:] = False
    sb["points"] = np.where(sb["mask"][..., None], sb["points"], np.float32(1e6))
    want = infer(cpu_model, batch_to_device(sb, "cpu"))
    got = infer(gpu_model, batch_to_device(sb, dev)).cpu()
    mask = torch.from_numpy(sb["mask"])
    err = float((got - want).abs()[mask].max())
    scale = float(want.abs()[mask].max())
    emit({"phase": "parity", "config": "ARCHITECTURE_DEEPER, N0=1024, width 32, 3 views 24x32, f32",
          "max_abs_err": err, "max_abs_logit": scale, "limit": PARITY_REL * scale})
    assert bool(torch.isfinite(got).all()) and err <= PARITY_REL * scale, "card/CPU logits disagree"

    # ---- the slice at full width ----
    model = make_model(cfg, dev, seed=0)
    logits = infer(model, batch)  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    k1.radius_topk.launches = 0
    k2.pixel_topk.launches = 0
    forwards = 5
    t0 = time.perf_counter()
    for _ in range(forwards):
        logits = infer(model, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / forwards
    launches = {"radius_topk": k1.radius_topk.launches, "pixel_topk": k2.pixel_topk.launches}
    assert tuple(logits.shape) == (cfg.batch_num, cfg.num_points[0], cfg.num_classes), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert launches["radius_topk"] == 13 * forwards, launches
    assert launches["pixel_topk"] == forwards, launches
    emit({
        "phase": "full", "config": "bench.py:106-117 (B=4, N0=16384, K=30, V=5, 120x160, width 128, bf16)",
        "forwards": forwards, "ms_per_forward": dt * 1e3,
        "points_per_s": cfg.batch_num * cfg.num_points[0] / dt, "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "logit_abs_max": float(logits.abs().max()), "card": smi,
    })

    l0 = k1_rows[0]
    bf16 = k2_rows[0]
    emit({"kernels": [
        {"name": "radius_topk", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/radius_topk.cu",
         "replaces": "mvkpconv_tpu/ops/pallas/radius_topk.py:121",
         "launches": launches["radius_topk"],
         "max_abs_err": max(r["max_d2_gap"] for r in k1_rows),
         "ms": l0["ms"], "plain_ms": l0["plain_ms"]},
        {"name": "pixel_topk", "route": "cuda", "source": "mvkpconv_tpu_torch/csrc/pixel_select.cu",
         "replaces": "mvkpconv_tpu/ops/pallas/pixel_select.py:97",
         "launches": launches["pixel_topk"],
         "max_abs_err": max(r["max_d2_gap"] for r in k2_rows),
         "ms": bf16["ms"], "plain_ms": bf16["plain_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
