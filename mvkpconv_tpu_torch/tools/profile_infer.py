"""Where the inference slice's (or the train step's) time goes on one GPU.

    python3 -m mvkpconv_tpu_torch.tools.profile_infer [--train] [--fused] [--out DIR]

At the bench configuration (B=4, N0=16384, 5 levels, K=30, 5 views of
120×160, width 128, bf16, seeded random weights), or with ``--fused`` at the
same configuration on the fused KPConv path (``use_pallas_kpconv=True``,
``influence_cache='none'``: kernel K4 in every conv block, no influence
cache), it prints one line per hand-written kernel (its device time and
launches per forward or step) and then one JSON line:

  * ``stage_ms``: device time per forward (or per train step) by stage,
    from CUDA events around the unmodified code, mean of 5 runs after a
    warm-up. Forward: the pyramid and the model's submodules (UNet,
    FeatureAggregation, encoder, decoder, head); ``other`` is the rest of
    the model forward (unprojection, pixel association through K2, the
    lift gather, the influence cache). ``--train``: the pyramid, the
    forward (the model's submodules as above), the backward (the loss, then
    autograd with every trunk gather's VJP through K3) and the optimizer
    (value clip and SGD);
  * ``device_busy_ms`` and the top kernels by device time, per forward or
    step, from ``torch.profiler`` over 3 runs; ``kernel_sums_ms``: the
    hand-written kernels' device time per forward or step, summed by kernel
    (K1 = the box pre-pass and the search, K4's forward, ``bwd_x`` and ``wf``,
    K2, K3), with their launches.

The full profiler table goes to ``DIR/profile_infer.txt`` (or
``profile_train.txt``, each with ``_fused`` before the dot under ``--fused``;
default ``outputs/``, which git ignores).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
from mvkpconv_tpu_torch.infer import batch_to_device, bench_config, fused_config, make_model
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid
from mvkpconv_tpu_torch.train import make_trainer

STAGES = ("net_2d", "feat_aggreg", "encoder", "decoder", "head")
# the hand-written kernels, by a part of their profiler names
OWN_KERNELS = {
    "k1_radius_topk": ("radius_topk_kernel", "radius_boxes_kernel"),
    "k2_pixel_topk": ("pixel_topk_kernel",),
    "k3_segsum": ("segsum",),
    "k4_fwd": ("kpconv_fwd_kernel",),
    "k4_bwd_x": ("kpconv_bwd_x_kernel",),
    "k4_wf": ("kpconv_wf_kernel",),
}


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _hook_spans(model, spans):
    """Record (start, end) events of each stage submodule and of the whole
    model forward into ``spans``."""
    open_ = {}
    for name, mod in [(n, getattr(model, n)) for n in STAGES] + [("model", model)]:
        mod.register_forward_pre_hook(lambda m, a, n=name: open_.__setitem__(n, _event()))
        mod.register_forward_hook(
            lambda m, a, o, n=name: spans.setdefault(n, []).append((open_.pop(n), _event()))
        )


def inference_runner(cfg, dev, batch, spans):
    model = make_model(cfg, dev, seed=0)
    _hook_spans(model, spans)
    spec = cfg.pyramid_spec()

    @torch.inference_mode()
    def run():
        t0 = _event()
        pyr = build_pyramid(batch["points"], batch["mask"], spec)
        spans.setdefault("pyramid", []).append((t0, _event()))
        model(batch, pyr)

    return run


def train_runner(cfg, dev, batch, spans):
    trainer = make_trainer(cfg, dev, seed=0)
    _hook_spans(trainer.model, spans)
    opt_step = trainer.optimizer.step

    def timed_opt_step():
        spans.setdefault("backward_end", []).append(_event())
        opt_step()
        spans.setdefault("optimizer_end", []).append(_event())

    trainer.optimizer.step = timed_opt_step

    def run():
        spans.setdefault("step_start", []).append(_event())
        trainer.step(batch)

    return run


def stage_ms(spans, train: bool):
    ms = {k: float(np.mean([s.elapsed_time(e) for s, e in v]))
          for k, v in spans.items() if k in STAGES + ("model", "pyramid")}
    ms["other"] = ms["model"] - sum(ms[n] for n in STAGES)
    if not train:
        ms["forward"] = ms.pop("model") + ms["pyramid"]
        return ms
    def mean(starts, ends):
        return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))

    starts = spans["step_start"]
    fwd_s = [s for s, _ in spans["model"]]
    fwd_e = [e for _, e in spans["model"]]
    ms["pyramid"] = mean(starts, fwd_s)
    ms["forward"] = ms.pop("model")
    ms["backward"] = mean(fwd_e, spans["backward_end"])
    ms["optimizer"] = mean(spans["backward_end"], spans["optimizer_end"])
    ms["step"] = mean(starts, spans["optimizer_end"])
    return ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile the train step")
    ap.add_argument("--fused", action="store_true",
                    help="the fused KPConv path (K4, no influence cache)")
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_infer: needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = fused_config() if args.fused else bench_config()
    batch = batch_to_device(make_batch(cfg, cfg.batch_num, np.random.RandomState(0)), dev)
    spans = {}
    run = (train_runner if args.train else inference_runner)(cfg, dev, batch, spans)

    run()
    spans.clear()
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    ms = stage_ms(spans, args.train)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = ("profile_train" if args.train else "profile_infer") + ("_fused" if args.fused else "")
    (out / f"{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=60)
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    sums = {}
    for label, parts in OWN_KERNELS.items():
        mine = [e for e in kernels if any(part in e.key for part in parts)]
        if mine:
            sums[label] = {"ms": sum(e.self_device_time_total for e in mine) / 3e3,
                           "launches": sum(e.count for e in mine) // 3}
    for label, row in sums.items():
        print(f"{label}: {row['ms']:.4f} ms in {row['launches']} launches per "
              f"{'step' if args.train else 'forward'}")
    print(json.dumps({
        "card": smi, "mode": "train" if args.train else "inference",
        "path": "fused (K4, influence_cache='none')" if args.fused else "default (einsum, prebuilt cache)",
        "stage_ms": ms,
        "device_busy_ms": sum(e.self_device_time_total for e in kernels) / 3e3,
        "kernel_sums_ms": sums,
        "top_kernels_ms": [
            [e.key[:80], e.self_device_time_total / 3e3, e.count // 3] for e in kernels[:15]
        ],
    }))


if __name__ == "__main__":
    main()
