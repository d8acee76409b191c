"""What a traced run (``--trace 1``) records, from the benchmark's own hooks
around the program's layers (spans inside the program are a later
change):

  * CUDA-event spans of every step of the window: the pyramid
    (``build_pyramid`` as the step calls it, through ``mvkpconv_tpu_torch.infer``),
    the model's forward and each of its stage submodules (``net_2d``,
    ``feat_aggreg``, the encoders, ``decoder``, ``head``), and the parts of
    a call that a loop marks (``Program.span``);
  * after the window, ``torch.profiler`` over a short stretch of further
    steps, each span also a ``record_function`` range there: the device's
    busy time (the union of its kernels', copies' and fills' intervals),
    the window's length, device time by kernel, and the idle gaps labelled
    by the span the host was in.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

STAGES = ("net_2d", "feat_aggreg", "encoder", "encoder_3d", "encoder_2d", "decoder", "head")
TRUNK = ("encoder", "encoder_3d", "encoder_2d", "decoder", "head")


class _HostEvent:
    """A host-clock stand-in for a CUDA event, where the run has no card
    (the harness's CPU tests)."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


def _event():
    if not torch.cuda.is_available():
        return _HostEvent()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Spans:
    """Spans of the program's layers: CUDA events always, profiler ranges
    while ``profiling``."""

    def __init__(self):
        self.events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = defaultdict(list)
        self._open: Dict[str, Tuple[torch.cuda.Event, object]] = {}
        self.profiling = False

    def begin(self, name: str) -> None:
        ev = _event()
        rng = None
        if self.profiling:
            rng = torch.profiler.record_function(f"portbench.{name}")
            rng.__enter__()
        self._open[name] = (ev, rng)

    def end(self, name: str) -> None:
        start, rng = self._open.pop(name)
        ev = _event()
        if rng is not None:
            rng.__exit__(None, None, None)
        self.events[name].append((start, ev))

    @contextlib.contextmanager
    def span(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def ms(self) -> Dict[str, List[float]]:
        """Milliseconds of each span, in order (synchronises)."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}

    def clear(self) -> None:
        self.events.clear()


@contextlib.contextmanager
def hooked(spans: Spans, model: torch.nn.Module):
    """Spans around the program's layers for the duration of the block: the
    pyramid, the model and its stages."""
    import mvkpconv_tpu_torch.infer as entry

    handles = []
    for name in STAGES + ("model",):
        mod = model if name == "model" else getattr(model, name, None)
        if mod is None:
            continue
        handles.append(mod.register_forward_pre_hook(lambda m, a, n=name: spans.begin(n)))
        handles.append(mod.register_forward_hook(lambda m, a, o, n=name: spans.end(n)))
    build = entry.build_pyramid

    def timed_build(*args, **kwargs):
        with spans.span("pyramid"):
            return build(*args, **kwargs)

    entry.build_pyramid = timed_build
    try:
        yield
    finally:
        entry.build_pyramid = build
        for h in handles:
            h.remove()


def step_spans(spans: Spans) -> Dict[str, List[float]]:
    """Per step: ``pyramid``, ``model``, each stage, ``trunk`` (the trunk
    stages' sum) and ``lift`` (the model's forward less its trunk: the UNet,
    the unprojection, K2, the lift gather, the aggregation, the influence
    cache), ms."""
    ms = spans.ms()
    out = {k: v for k, v in ms.items() if k in STAGES + ("pyramid", "model")}
    steps = len(ms.get("model", []))
    trunk = [sum(ms[k][i] for k in TRUNK if k in ms) for i in range(steps)]
    out["trunk"] = trunk
    out["lift"] = [ms["model"][i] - trunk[i] for i in range(steps)]
    return out


def _union(intervals):
    total, end = 0.0, None
    out = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            out.append([s, e])
            end = e
        elif e > end:
            out[-1][1] = e
            end = e
    for s, e in out:
        total += e - s
    return total, out


def profile_summary(prof, top: int = 10) -> Dict:
    """Reduce a ``torch.profiler`` run whose steps ran inside a
    ``portbench.window`` range: busy and window seconds, device seconds by
    kernel, the longest idle gaps."""
    events = prof.events()
    window = [e for e in events if e.name == "portbench.window"]
    if not window:
        return {}
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    # the device's kernels, copies and fills: not the ranges' own device-side
    # annotations
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and not e.name.startswith("portbench.")
              and e.time_range.end > w0 and e.time_range.start < w1]
    spans = [(e.time_range.start, e.time_range.end, e.name[len("portbench."):]) for e in events
             if e.name.startswith("portbench.") and e.name != "portbench.window"]
    busy_us, merged = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device])
    by_name = defaultdict(float)
    for e in device:
        by_name[e.name[:96]] += (e.time_range.end - e.time_range.start) / 1e6
    gaps = []
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = 0.5 * (s + e)
            inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            label = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else "between steps"
            gaps.append([label, (e - s) / 1e6])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:top],
    }
