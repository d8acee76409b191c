"""Where the inference slice's time goes on one GPU.

    python3 -m mvkpconv_tpu_torch.tools.profile_infer [--out DIR]

At the bench configuration (B=4, N0=16384, 5 levels, K=30, 5 views of
120×160, width 128, bf16, seeded random weights) it prints one JSON line:

  * ``stage_ms``: device time of the pyramid and of the model's
    submodules (UNet, FeatureAggregation, encoder, decoder, head), from
    CUDA events recorded by forward hooks around the unmodified forward,
    mean of 5 forwards after a warm-up; ``other`` is the rest of the model
    forward (unprojection, pixel association through K2, the lift gather,
    the influence cache);
  * ``device_busy_ms_per_forward`` and the top kernels by device time,
    from ``torch.profiler`` over 3 forwards.

The full profiler table goes to ``DIR/profile_infer.txt`` (default
``outputs/``, which git ignores).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
from mvkpconv_tpu_torch.infer import batch_to_device, bench_config, make_model
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid

STAGES = ("net_2d", "feat_aggreg", "encoder", "decoder", "head")


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@torch.inference_mode()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_infer: needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = bench_config()
    spec = cfg.pyramid_spec()
    model = make_model(cfg, dev, seed=0)
    batch = batch_to_device(make_batch(cfg, cfg.batch_num, np.random.RandomState(0)), dev)

    spans = {}  # stage -> [(start, end), ...]
    open_ = {}
    for name in STAGES:
        mod = getattr(model, name)
        mod.register_forward_pre_hook(lambda m, a, n=name: open_.__setitem__(n, _event()))
        mod.register_forward_hook(
            lambda m, a, o, n=name: spans.setdefault(n, []).append((open_.pop(n), _event()))
        )

    def forward():
        t0 = _event()
        pyr = build_pyramid(batch["points"], batch["mask"], spec)
        t1 = _event()
        model(batch, pyr)
        t2 = _event()
        spans.setdefault("pyramid", []).append((t0, t1))
        spans.setdefault("model", []).append((t1, t2))

    forward()
    spans.clear()
    for _ in range(5):
        forward()
    torch.cuda.synchronize()
    ms = {k: float(np.mean([s.elapsed_time(e) for s, e in v])) for k, v in spans.items()}
    ms["other"] = ms["model"] - sum(ms[n] for n in STAGES)
    ms["forward"] = ms.pop("model") + ms["pyramid"]

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(3):
            forward()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_infer.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=60)
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({
        "card": smi, "stage_ms": ms,
        "device_busy_ms_per_forward": sum(e.self_device_time_total for e in kernels) / 3e3,
        "top_kernels_ms_per_forward": [
            [e.key[:80], e.self_device_time_total / 3e3, e.count // 3] for e in kernels[:15]
        ],
    }))


if __name__ == "__main__":
    main()
