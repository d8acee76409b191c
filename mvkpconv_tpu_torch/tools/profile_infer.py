"""Where the inference slice's (or the train step's) time goes on one GPU.

    python3 -m mvkpconv_tpu_torch.tools.profile_infer [--train | --serving] [--fused]
        [--config bench|middle|late|deform|baseline] [--out DIR]

At the bench configuration (B=4, N0=16384, 5 levels, K=30, 5 views of
120×160, width 128, bf16, seeded random weights), or with ``--fused`` at the
same configuration on the fused KPConv path (``use_pallas_kpconv=True``,
``influence_cache='none'``: kernel K4 in every conv block, no influence
cache), it prints one line per hand-written kernel (its device time and
launches per forward or step) and then one JSON line. ``--config middle``
and ``--config late`` take the bench configuration with middle or late
fusion (``infer.fusion_config``: two encoders, ``encoder_3d`` on the 2 base
columns and ``encoder_2d`` on ones ⊕ the lifted features, their skips
concatenated; or one encoder on the base columns and the lifted features
joined after the decoder), ``--config deform`` ``infer.deform_config()``
(blocks 9–13 deformable) and ``--config baseline``
``infer.baseline_config()`` (the 3D-only KPFCNN: no UNet, no
FeatureAggregation, no lift) in place of the bench configuration:

  * ``stage_ms``: device time per forward (or per train step) by stage,
    from CUDA events around the unmodified code, mean of 5 runs after a
    warm-up. Forward: the pyramid and the model's submodules (UNet,
    FeatureAggregation, encoder, or ``encoder_3d`` and ``encoder_2d`` in
    middle fusion, decoder, head); ``other`` is the rest of
    the model forward (unprojection, pixel association through K2, the
    lift gather, the influence cache). ``--train``: the pyramid, the
    forward (the model's submodules as above), the backward (the loss, then
    autograd with every trunk gather's VJP through K3) and the optimizer
    (value clip and SGD); ``deformable_kpconv``, where the model has
    deformable layers, is their forward's share, inside ``encoder``;
  * ``device_busy_ms`` and the top kernels by device time, per forward or
    step, from ``torch.profiler`` over 3 runs; ``kernel_sums_ms``: the
    hand-written kernels' device time per forward or step, summed by kernel
    (K1 = the box pre-pass and the search, K4's forward, ``bwd_x`` and ``wf``,
    K2, K3), with their launches;
  * ``gather_vjp_ms`` (``--train``): every device kernel launched inside the
    gather VJP (``_GroupPointsBackward``), per step, summed by kind: K3, the
    rounding cast of the cotangent to bf16, the zero fill of the output, and
    any other, with their launches. Since K3 rounds f32 rows itself and
    writes its whole output, the cast and the fill should read zero on both
    paths.

``--serving`` profiles the serving artifact (``eval/export.export_inference``
of the same model, loaded by ``ServingModel``) beside the eager forward
(``infer`` and a softmax), each called in turn: ``host_ms`` a call (host
clock, synchronized, mean of 10 rounds) of the eager forward, of the
artifact as a user calls it, of its module without the input check, of that
module under ``torch.inference_mode`` (as ``infer`` runs), and of the check
alone; and for each under ``torch.profiler`` over 3 calls the device busy
ms, device launches, operator calls and their host ms a call, the operators
with the most host time, and the device kernels whose launches differ
between the eager forward and the artifact.

The full profiler table goes to ``DIR/profile_infer.txt`` (or
``profile_train.txt``, each with ``_fused`` before the dot under ``--fused``
and ``_middle``, ``_late``, ``_deform`` or ``_baseline`` under ``--config``; default ``outputs/``,
which git ignores).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from mvkpconv_tpu_torch.data.synthetic_batch import make_batch
from mvkpconv_tpu_torch.infer import (
    FUSED_OPTIONS,
    apply_model,
    baseline_config,
    batch_to_device,
    bench_config,
    deform_config,
    fusion_config,
    make_model,
)
from mvkpconv_tpu_torch.models.blocks import KPConvLayer
from mvkpconv_tpu_torch.ops.pyramid import build_pyramid
from mvkpconv_tpu_torch.train import make_trainer

CONFIGS = {"bench": bench_config, "middle": lambda: fusion_config("middle"),
           "late": lambda: fusion_config("late"), "deform": deform_config, "baseline": baseline_config}

STAGES = ("net_2d", "feat_aggreg", "encoder", "encoder_3d", "encoder_2d", "decoder", "head")
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
    """Record (start, end) events of each stage submodule the model has, of
    each deformable KPConv layer and of the whole model forward into
    ``spans``."""
    open_ = {}
    stages = [(n, getattr(model, n)) for n in STAGES if hasattr(model, n)]
    deform = [(f"deformable_kpconv.{i}", m) for i, m in enumerate(
        m for m in model.modules() if isinstance(m, KPConvLayer) and m.deformable)]
    for name, mod in stages + deform + [("model", model)]:
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
        apply_model(model, batch, pyr)

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
    ms["other"] = ms["model"] - sum(ms[n] for n in STAGES if n in ms)
    deform = [k for k in spans if k.startswith("deformable_kpconv.")]
    if deform:
        ms["deformable_kpconv"] = sum(
            float(np.mean([s.elapsed_time(e) for s, e in spans[k]])) for k in deform)
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


def _vjp_kind(name: str) -> str:
    low = name.lower()
    if "segsum" in low:
        return "k3_segsum"
    if "fill" in low:
        return "zero_fill"
    if "copy" in low or "bfloat16" in low:
        return "cast"
    return "other"


def gather_vjp_kernels(prof, runs: int):
    """Device kernels launched inside the gather VJP's backward
    (``_GroupPointsBackward`` and the ops under it), ms and launches per run,
    by kind and by name."""
    events = prof.events()
    nodes = [e for e in events if e.name == "_GroupPointsBackward"] or [
        e for e in events if e.name.endswith("_GroupPointsBackward")]
    by_kind, by_name = {}, {}
    stack = list(nodes)
    while stack:
        evt = stack.pop()
        stack.extend(evt.cpu_children)
        for k in evt.kernels:
            for table, key in ((by_kind, _vjp_kind(k.name)), (by_name, k.name[:80])):
                row = table.setdefault(key, {"ms": 0.0, "launches": 0})
                row["ms"] += k.duration / 1e3 / runs
                row["launches"] += 1
    for table in (by_kind, by_name):
        for row in table.values():
            row["launches"] /= runs
    return {"nodes_per_run": len(nodes) / runs, "by_kind": by_kind, "by_name": by_name}


def _profile(fn, runs: int = 3):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return prof


def serving_profile(cfg, dev, batch, smi, rounds: int = 10, runs: int = 3):
    """The serving artifact beside the eager forward (module docstring)."""
    import time

    from mvkpconv_tpu_torch.eval.export import ServingModel, export_inference
    from mvkpconv_tpu_torch.infer import infer

    model = make_model(cfg, dev, seed=0)
    served = ServingModel.from_bytes(export_inference(model, cfg))
    sb = {k: batch[k] for k in served.input_spec}

    def module_no_grad():
        with torch.no_grad():
            return served._module(sb)

    @torch.inference_mode()
    def module_inference_mode():
        return served._module(sb)

    runners = {
        "eager": lambda: torch.softmax(infer(model, batch), dim=-1),
        "artifact": lambda: served(sb),
        "artifact_module": module_no_grad,
        "artifact_module_inference_mode": module_inference_mode,
        "check": lambda: served._check(sb),
    }
    times = {k: [] for k in runners}
    for fn in runners.values():  # warm-up
        fn()
    for _ in range(rounds):
        for name, fn in runners.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    host_ms = {k: float(np.mean(v)) for k, v in times.items()}
    profiles, launches, op_counts = {}, {}, {}
    for name in ("eager", "artifact", "artifact_module_inference_mode"):
        events = _profile(runners[name], runs).key_averages()
        dev_ev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith(("aten::", "mvkpconv::"))]
        launches[name] = {e.key[:80]: e.count / runs for e in dev_ev}
        op_counts[name] = {e.key: e.count / runs for e in ops}
        profiles[name] = {
            "device_busy_ms": sum(e.self_device_time_total for e in dev_ev) / runs / 1e3,
            "device_launches": sum(e.count for e in dev_ev) / runs,
            "op_calls": sum(e.count for e in ops) / runs,
            "op_self_host_ms": sum(e.self_cpu_time_total for e in ops) / runs / 1e3,
            "top_ops_host_ms": [[e.key, e.self_cpu_time_total / runs / 1e3, e.count / runs]
                                for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                                                reverse=True)[:12]],
        }
    def diff(table):  # [name, eager, artifact] where the counts a call differ
        rows = ([k, table["eager"].get(k, 0.0), table["artifact"].get(k, 0.0)]
                for k in set(table["eager"]) | set(table["artifact"]))
        return sorted((r for r in rows if r[1] != r[2]), key=lambda r: abs(r[2] - r[1]), reverse=True)[:20]

    print(json.dumps({"card": smi, "mode": "serving", "config": "fused" if cfg.use_pallas_kpconv else "default",
                      "host_ms": host_ms, "profiles": profiles,
                      "launch_diff_eager_vs_artifact": diff(launches),
                      "op_diff_eager_vs_artifact": diff(op_counts)}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true", help="profile the train step")
    ap.add_argument("--serving", action="store_true",
                    help="the serving artifact beside the eager forward")
    ap.add_argument("--fused", action="store_true",
                    help="the fused KPConv path (K4, no influence cache)")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="bench",
                    help="the bench configuration (early fusion), middle or late fusion, its "
                         "deformable variant or the KPFCNN baseline")
    ap.add_argument("--out", default="outputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_infer: needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = CONFIGS[args.config]()
    if args.fused:
        cfg = cfg.replace(**FUSED_OPTIONS)
    batch = batch_to_device(make_batch(cfg, cfg.batch_num, np.random.RandomState(0)), dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    if args.serving:
        return serving_profile(cfg, dev, batch, smi)
    spans = {}
    run = (train_runner if args.train else inference_runner)(cfg, dev, batch, spans)

    run()
    spans.clear()
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    ms = stage_ms(spans, args.train)

    prof = _profile(run)
    events = prof.key_averages()
    kernels = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = ("profile_train" if args.train else "profile_infer") + ("_fused" if args.fused else "")
    name += "" if args.config == "bench" else f"_{args.config}"
    (out / f"{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=60)
    )
    sums = {}
    for label, parts in OWN_KERNELS.items():
        mine = [e for e in kernels if any(part in e.key for part in parts)]
        if mine:
            sums[label] = {"ms": sum(e.self_device_time_total for e in mine) / 3e3,
                           "launches": sum(e.count for e in mine) // 3}
    for label, row in sums.items():
        print(f"{label}: {row['ms']:.4f} ms in {row['launches']} launches per "
              f"{'step' if args.train else 'forward'}")
    vjp = gather_vjp_kernels(prof, 3) if args.train else None
    if vjp is not None:
        for kind in ("k3_segsum", "cast", "zero_fill", "other"):
            row = vjp["by_kind"].get(kind, {"ms": 0.0, "launches": 0})
            print(f"gather_vjp {kind}: {row['ms']:.4f} ms in {row['launches']:g} launches per step")
    print(json.dumps({
        "card": smi, "mode": "train" if args.train else "inference", "config": args.config,
        "path": "fused (K4, influence_cache='none')" if args.fused else "default (einsum, prebuilt cache)",
        "stage_ms": ms,
        "device_busy_ms": sum(e.self_device_time_total for e in kernels) / 3e3,
        "kernel_sums_ms": sums,
        "gather_vjp_ms": vjp,
        "top_kernels_ms": [
            [e.key[:80], e.self_device_time_total / 3e3, e.count // 3] for e in kernels[:15]
        ],
    }))


if __name__ == "__main__":
    main()
