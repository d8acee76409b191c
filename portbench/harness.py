"""One run of one cell: set-up, the measured window, the check against the
reference, the result line.

Everything that belongs to one cell is found by name, so that a new cell,
configuration, traffic mix, generator, loop or metric is a new file and a
new entry: the cell in ``BENCHMARK.json``; its configuration's file
(``configs/<name>.json``); its traffic mix (``traffic/<mix>.json``), whose
``generator`` names the module that makes the pool of host batches
(``traffic/<generator>.py``) and whose ``loop`` the module that drives the
program (``loops/<loop>.py``); its limits (``limits/<cell>.json``); each of
its metrics (``metrics/<metric>.py``, a ``read(run)`` that returns the
number or None); and the reference the check holds the program to, the
module that the configuration's file names under ``reference``.

A reference module lives under ``portbench.``, imports only ``torch`` and
``numpy`` (nothing of ``jax``, ``mvkpconv_tpu`` or ``mvkpconv_tpu_torch``)
and provides:

  * ``tensors(model) -> [(name, shape, kind)]``: every weight and
    statistic, named as the port's ``state_dict``, of the kinds that
    ``weights.draw`` knows (conv, deconv, linear, kpconv, bias, bn_weight,
    running_mean, running_var);
  * ``calibrate(model, weights, batch)``: every batch norm's running
    statistics set in place from the batch;
  * ``logits(model, weights, batch) -> (logits, lengths)``: the real
    points' logits stacked (P, C), eval mode, float32 with TF32 off;
  * ``peak_seconds(model, batch, train, tf32) -> float``: the least time of
    one step at the published peaks, from what the batch's geometry needs
    (``tf32``: the switches ``{"matmul": bool, "cudnn": bool}`` in force).

``Cell.model`` carries the module's name, so each of these is reached
through the model dict (``references.of``) by the weights, the check and
the counts, and by a loop's ``check_run``.

A loop module provides:

  * ``KIND``: the kind of run its records carry (``run["kind"]``), which
    the metric readers check; ``TRAINS``: whether its step trains (for the
    operations ``mfu.*`` counts);
  * ``build(model, conf, weights, device, overrides)``: the system under
    test through the program's own entry point, a :class:`Program`;
  * ``warm(program, pool)``: the set-up's calls through the window's own
    call, returning what its check needs of them;
  * ``drive(program, pool, seconds)``: the window, closed by a synchronise
    (``order`` of the pool's batches, ``window_s``, ``failed``, and what its
    readers and check read);
  * ``check_run(model, weights, pool, run, warmed, seed, device)``: after
    the window and with the program freed, ``{number: value}`` against the
    reference;
  * ``FAULTS``: ``{name: hook(program)}``, the faults its cells can have,
    planted under the timed path (the tests, ``portbench.calibrate``).

Set-up: the pool from the seed (numpy), the weights drawn on the device from
the seed and calibrated by the reference, the program built and loaded with
them, the loop's warm-up. Precision: the configuration's TF32 switches for
the whole run.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import check, references, trace
from portbench.traffic.generator import load_mix, load_module, make_pool, seeds
from portbench.weights import calibrate, draw

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mvkpconv_tpu")  # top-level module names, compared whole


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_metric(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"portbench.metrics.{name}")


def load_loop(name: str):
    return load_module(HERE / "loops" / f"{name}.py", f"portbench.loops.{name}")


def load_config(name: str) -> Dict:
    """A configuration's file (``configs/<name>.json``)."""
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


class Cell:
    """A configuration under a traffic mix, with the limits of its check and
    the metrics it reports (each a dict with ``name`` and ``unit``)."""

    def __init__(self, name: str, conf: Dict, mix: Dict, limits: Optional[Dict[str, float]] = None,
                 end_to_end=(), per_layer=(), chips: int = 1):
        self.name, self.conf, self.mix, self.chips = name, conf, mix, chips
        self.reference = references.load(conf.get("reference"))
        self.limits = dict(limits or {})
        self.end_to_end, self.per_layer = list(end_to_end), list(per_layer)

    @classmethod
    def from_benchmark(cls, name: str, bench: Optional[Dict] = None) -> "Cell":
        """A workload of ``BENCHMARK.json``."""
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
        entry = cells[name]
        config = {c["name"]: c for c in bench["configs"]}[entry["config"]]

        def applies(m):
            return name in m.get("workloads", [name])

        return cls(name, json.loads((ROOT / config["file"]).read_text()), load_mix(entry["traffic"]),
                   check.limits(name), [m for m in bench["end_to_end"] if applies(m)],
                   [m for m in bench["per_layer"] if applies(m)], entry["chips"])

    @property
    def model(self) -> Dict:
        """The configuration's model dict, with the name of its reference."""
        return {**self.conf["model"], "reference": self.conf["reference"]}

    @property
    def loop(self):
        return load_loop(self.mix["loop"])


def port_config(model: Dict, overrides: Optional[Dict] = None):
    """The program's ``KPConfig`` of a configuration's model dict."""
    import dataclasses

    from mvkpconv_tpu_torch.training.config import KPConfig

    names = {f.name for f in dataclasses.fields(KPConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items() if k in names}
    return KPConfig(**kw).replace(**(overrides or {})).validate()


def to_device(host: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The benchmark's own copy of a host batch, for the reference."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}


class Program:
    """The system under test, built by a loop module: ``call(host_batch)`` is
    the window's call; ``net`` the model (its stages carry the traced run's
    spans); ``span(name)`` a span of the traced run around a part of a call."""

    def __init__(self, device):
        self.device, self.spans, self.net = torch.device(device), None, None

    def span(self, name):
        return self.spans.span(name) if self.spans is not None else _nothing()

    def call(self, host):
        raise NotImplementedError


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def precision(tf32: Dict):
    """PyTorch's process-wide TF32 switches as the configuration states them
    (``{"matmul": bool, "cudnn": bool}``), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32.get("matmul", saved[0])
    torch.backends.cudnn.allow_tf32 = tf32.get("cudnn", saved[1])
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float,
             program_hook: Optional[Callable] = None, overrides: Optional[Dict] = None) -> Dict:
    """One run; returns the run record (``kind``, ``setup_s``, ``window_s``,
    ``steps``, ``points``, what the loop's drive returns, ``checks``:
    {number: value}). ``program_hook(program)`` may replace parts of the
    program before the warm-up (a fault of the loop's ``FAULTS``);
    ``overrides`` change the configuration's ``tf32`` switches or the
    program's ``KPConfig`` fields (a control)."""
    overrides = dict(overrides or {})
    with precision(overrides.pop("tf32", cell.conf.get("tf32", {}))):
        return _run_cell(cell, seed, seconds, traced, device, t0, program_hook, overrides)


def _run_cell(cell, seed, seconds, traced, device, t0, program_hook, overrides) -> Dict:
    model, loop = cell.model, cell.loop
    s_pool, s_weights, s_sample = seeds(seed, 3)
    parts = {"start": time.perf_counter() - t0}
    pool = make_pool(model, cell.mix, s_pool)
    parts["pool"] = time.perf_counter() - t0
    weights = draw(model, s_weights, device)
    calibrate(model, weights, to_device(pool.batches[0], device))
    sync(device)
    parts["weights"] = time.perf_counter() - t0
    prog = loop.build(model, cell.conf, weights, device, overrides)
    sync(device)
    parts["program"] = time.perf_counter() - t0
    if program_hook is not None:
        program_hook(prog)
    weights = {k: v.to("cpu", copy=True) for k, v in weights.items()}  # off the card while the program runs
    warmed = loop.warm(prog, pool)
    sync(device)
    rec: Dict = {"kind": loop.KIND, "fill": pool.fill, "setup_s": time.perf_counter() - t0,
                 "setup_parts": parts}  # seconds since the start at the end of each stage

    spans = trace.Spans() if traced else None
    hooks = trace.hooked(spans, prog.net) if traced else _nothing()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with hooks:
        prog.spans = spans
        rec.update(loop.drive(prog, pool, seconds))
        if torch.device(device).type == "cuda":
            rec["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        if traced:
            rec["spans"] = trace.step_spans(spans)
            spans.clear()
            # one call on each batch of the pool, for the profile and again
            # for the program's spans: the same work in every run
            n = len(pool.batches)
            profiled = [(len(rec["order"]) + k) % n for k in range(n)]
            rec["profile"] = _profile(prog, pool, profiled, spans, device)
    prog.spans = None
    if traced:
        rec["program"] = program_spans(prog, pool, profiled, device)
    order = rec["order"]
    rec.update(steps=len(order), points=int(sum(pool.real_points[j] for j in order)))
    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    wdev = {k: v.to(device) for k, v in weights.items()}
    rec["checks"] = loop.check_run(model, wdev, pool, rec, warmed, s_sample, device)
    if traced:
        rec["counts"] = _counts(model, pool, order, loop.TRAINS, device)
    return rec


def _profile(prog: Program, pool, indices: List[int], spans, device) -> Dict:
    if torch.device(device).type != "cuda":
        return {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        spans.profiling = True
        with torch.profiler.record_function("portbench.window"):
            for j in indices:
                with spans.span("step"):
                    prog.call(pool.batches[j])
            sync(device)
        spans.profiling = False
    return trace.profile_summary(prof)


def program_spans(prog: Program, pool, indices: List[int], device) -> Dict:
    """The program's own spans and counters (``mvkpconv_tpu_torch.tracing``)
    over one call on each of ``indices``, the tracer on only for them. Per
    span name, one value for each step (an outermost call of the program's,
    which shares its step id with every span inside it) in which it ran,
    summed over its records there: ``span_ms``, device ms by the tracer's
    CUDA events (none without a card); ``host_ms``; ``launches``, {kernel
    counter: launches}; ``counters``, for a span that counts query rows
    (K1's ``pyramid.neighbors``), ``rows`` and ``real_rows``."""
    from mvkpconv_tpu_torch import tracing

    tracing.enable()
    try:
        for j in indices:
            prog.call(pool.batches[j])
        sync(device)
        records = tracing.export()
    finally:
        tracing.disable()
    steps: Dict[str, Dict[int, List[dict]]] = {}
    for r in records:
        steps.setdefault(r["name"], {}).setdefault(r["step"], []).append(r)
    out: Dict[str, Dict] = {"span_ms": {}, "host_ms": {}, "launches": {}, "counters": {}}
    for name, by_step in steps.items():
        groups = [by_step[k] for k in sorted(by_step)]
        if all(r["device_ms"] is not None for g in groups for r in g):
            out["span_ms"][name] = [sum(r["device_ms"] for r in g) for g in groups]
        out["host_ms"][name] = [sum(r["t1_ns"] - r["t0_ns"] for r in g) / 1e6 for g in groups]
        out["launches"][name] = [dict(sum((Counter(r["launches"]) for r in g), Counter())) for g in groups]
        if any("rows" in r for g in groups for r in g):
            out["counters"][name] = {k: [sum(r.get(k, 0) for r in g) for g in groups] for k in ("rows", "real_rows")}
    return out


def _counts(model: Dict, pool, order: List[int], trains: bool, device) -> Dict:
    """Seconds the window's steps would take at the published peaks of the
    precision each class of operations runs at (the TF32 switches in force),
    from what each batch's geometry needs, by the model's reference."""
    reference = references.of(model)
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}
    peak = {j: reference.peak_seconds(model, to_device(pool.batches[j], device), trains, tf32)
            for j in sorted(set(order))}
    return {"peak_seconds": float(sum(peak[j] for j in order))}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(chips: int, peak: int) -> Dict:
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        limit = []
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak, "power_limit": limit[0] if limit else None}


def result(cell: Cell, rec: Dict, traced: bool) -> Dict:
    """The result line of a run record (without ``device``)."""
    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in entries:
        value = load_metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in rec["checks"].items()}
    out = {"correct": all(v <= cell.limits[k] for k, v in rec["checks"].items()) and rec["failed"] == 0,
           "attempted": rec["steps"], "failed": rec["failed"], "metrics": metrics}
    if traced and rec.get("profile"):
        out["breakdown"] = {"device_ops": rec["profile"]["device_ops"], "idle_gaps": rec["profile"]["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv, t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell.from_benchmark(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}", file=sys.stderr)
        return 3
    out = result(cell, rec, bool(args.trace))
    dev = device_info(cell.chips, rec["peak_bytes"])
    if args.trace and rec.get("profile"):
        dev.update(busy_s=rec["profile"]["busy_s"], window_s=rec["profile"]["window_s"])
    out = {k: out[k] for k in ("correct", "attempted", "failed", "metrics")} | {
        "device": dev, **({"breakdown": out["breakdown"]} if "breakdown" in out else {}),
        "fill": rec["fill"], "checks": out["checks"]}
    print(f"set-up stages (s from the start): {rec['setup_parts']}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
