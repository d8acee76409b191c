"""Spans and counters at the layer boundaries of the port's steps.

    from mvkpconv_tpu_torch import tracing

    tracing.enable()
    probs = step(batch_to_device(host, "cuda"))
    tracing.disable()
    records = tracing.export()  # handed over and cleared

Span sites (``with tracing.span(name): ...``) sit where the path of
``tools/test_models.py``'s ``predict`` crosses a layer, and in the train
step:

=====================  ==============================================  ==========================================
span                   site                                            children
=====================  ==============================================  ==========================================
``handoff``            ``infer.batch_to_device``                       —
``step``               ``make_eval_step``'s and ``make_train_step``'s   ``pyramid``, ``model``, ``softmax``;
                       step (``training/steps.py``)                    training: ``backward``, ``optimizer``
``pyramid``            ``ops/pyramid.py:build_pyramid``                ``pyramid.subsample``, ``pyramid.neighbors``
                                                                       (each with its ``level``)
``model``              ``MVKPConv.forward``, ``KPFCNN.forward``        ``lift``, ``influence``, ``encoder`` (or
                                                                       ``encoder_3d``, ``encoder_2d``),
                                                                       ``decoder``, ``head``
``lift``               ``MVKPConv.lift_2d_features``                   ``lift.unproject``, ``lift.pixel_select``
                                                                       (K2, or the exact pixel k-NN),
                                                                       ``lift.unet``, ``lift.gather``,
                                                                       ``lift.aggregate``
``influence``          ``models/kpfcnn.py:make_influence_cache``       ``sync.kernel_points``
``model`` (MVPNet)     ``MVPNet3D.forward``                            ``lift`` (the same children as above),
                                                                       ``pn2``
``pn2``                ``PN2SSG.forward``                              ``pn2.sa``, ``pn2.fp`` (each with its
                                                                       ``level``), ``head``
``pn2.sa``             ``models/pn2.py:SetAbstraction``                ``pn2.fps`` (P1), ``pn2.group`` (the
                                                                       centroids' gather), ``pn2.ball_query`` (P2),
                                                                       ``pn2.group`` (the neighbours'),
                                                                       ``pn2.sa.mlp`` (the MLP and the max)
``pn2.fp``             ``models/pn2.py:FeaturePropagation``            ``pn2.three_nn`` (P2), ``pn2.fp.mlp``
``sync.<where>``       a copy from host memory that waits for the      —
                       device (``sync.subsample``: the cell size in
                       ``ops/sampling.py:grid_subsample``)
=====================  ==============================================  ==========================================

Off (the default), a span site tests two flags (the tracer's and
``torch.autograd.profiler``'s) and enters a shared null context: no CUDA
event, no profiler range, no tensor operation, no allocation. While
``torch.export`` or ``torch.compile`` traces the code, a span is a null
context whatever the flags say, so an exported program is the same with the
tracer on or off.

Under an active ``torch.profiler``, on or off, each span also opens a
``record_function`` range ``mvkp.<span>``: the program's layers then lie on
the clock of the profiler's kernel, copy and fill records (and in
``Trainer(profile_steps=N)``'s Chrome trace); :func:`split_profile` puts
the device's idle time, the launch calls and the kernels' time down to them.

On (:func:`enable`), each span also records its name, its ``level`` (a
pyramid level, or None), its parent, its depth, a step id shared by every
span of one outermost call, its host interval (``time.perf_counter_ns``),
a pair of CUDA events for its device time (none where the machine has no
CUDA device), and the change in every hand-written kernel's launch counter
(:func:`launch_counts`) while it was open. ``pyramid.neighbors`` also
counts the query rows it hands to K1 and the real ones among them (the
query level's mask summed on the device, one small reduction a call);
``pn2.ball_query`` counts its neighbour slots and those a real hit fills
(:func:`count_rows`). The counters stay device tensors and Python ints
until :func:`export`, so an enabled tracer adds no synchronise to a step. Record a CUDA graph with the
tracer off: its events and reductions would be captured into the graph.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

from mvkpconv_tpu_torch.ops import _build

PREFIX = "mvkp."  # profiler ranges of the spans
OUTSIDE = "outside"  # split_profile's name for time outside every span

_on = False
_cuda = False
_records: List[dict] = []
_local = threading.local()
_steps = itertools.count(1)
_OFF = contextlib.nullcontext()


def enable() -> None:
    """Record every span from now on."""
    global _on, _cuda
    _cuda = torch.cuda.is_available()
    _on = True


def disable() -> None:
    """Stop recording; the records stay until :func:`export`."""
    global _on
    _on = False


def span(name: str, level: Optional[int] = None, queries: Optional[torch.Tensor] = None):
    """A context manager around one layer's work: a null context unless the
    tracer is on or a profiler runs (see the module's docstring). ``level``
    is the pyramid level a span works on; ``queries``, a K1 selection's
    query mask, counted when the tracer is on."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    if torch.compiler.is_compiling():
        return _OFF
    return _Span(name, level, queries)


def on() -> bool:
    """Whether spans record now: a site that counts rows asks first, so that
    the tracer off computes nothing for it."""
    return _on and not torch.compiler.is_compiling()


def count_rows(rows: torch.Tensor) -> None:
    """Rows for the innermost open span, counted as its ``queries`` would
    be: ``rows``, a bool tensor with one element a row, True where the row
    is real."""
    stack = _open_spans()
    if _on and stack:
        stack[-1]["rows"] = rows.numel()
        stack[-1]["_real"] = rows.sum()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def launch_counts() -> Dict[str, int]:
    """Each hand-written kernel's launch counter as it stands, a copy of
    ``ops/_build.py``'s ``LAUNCHES`` (K1's calls and, as
    ``radius_topk_device``, its two device launches a call)."""
    return dict(_build.LAUNCHES)


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "level", "queries", "rec", "rng", "counts")

    def __init__(self, name, level, queries):
        self.name, self.level, self.queries = name, level, queries
        self.rec = self.rng = self.counts = None

    def __enter__(self):
        t0 = time.perf_counter_ns()
        if _profiler._is_profiler_enabled:
            self.rng = _profiler.record_function(PREFIX + self.name)
            self.rng.__enter__()
        if _on:
            stack = _open_spans()
            parent = stack[-1] if stack else None
            rec = {"name": self.name, "level": self.level, "parent": parent, "depth": len(stack),
                   "step": parent["step"] if parent is not None else next(_steps), "t0_ns": t0}
            if self.queries is not None:
                rec["rows"] = self.queries.numel()
                rec["_real"] = self.queries.sum()
            self.counts = launch_counts()
            if _cuda:
                rec["_ev"] = (_event(), None)
            stack.append(rec)
            _records.append(rec)
            self.rec = rec
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if "_ev" in rec:
                rec["_ev"] = (rec["_ev"][0], _event())
            rec["launches"] = {k: v - self.counts[k] for k, v in launch_counts().items() if v != self.counts[k]}
            stack = _open_spans()
            if stack and stack[-1] is rec:
                stack.pop()
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        if rec is not None:
            rec["t1_ns"] = time.perf_counter_ns()
        return False


def export() -> List[dict]:
    """The records since the last export, in the order their spans opened,
    and clears them. Each is a dict: ``name``, ``level``, ``parent`` (the
    index of its parent's record in this list, or None), ``depth``,
    ``step``, ``t0_ns`` / ``t1_ns`` (host clock), ``device_ms`` (None
    without CUDA events), ``launches`` ({counter: launches while open},
    nonzero ones), and for ``pyramid.neighbors`` and ``pn2.ball_query``
``rows`` / ``real_rows``.
    Synchronises the device once to read the events; call it between
    steps, outside every span."""
    global _records
    if _open_spans():
        raise RuntimeError("tracing.export() inside an open span")
    records, _records = _records, []
    if any("_ev" in r for r in records):
        torch.cuda.synchronize()
    real = [r.pop("_real") for r in records if "_real" in r]
    real = torch.stack(real).tolist() if real else []
    index = {id(r): i for i, r in enumerate(records)}
    out, taken = [], iter(real)
    for r in records:
        ev = r.pop("_ev", None)
        parent = r["parent"]
        out.append({**r, "parent": None if parent is None else index[id(parent)],
                    "device_ms": ev[0].elapsed_time(ev[1]) if ev is not None and ev[1] is not None else None,
                    **({"real_rows": int(next(taken))} if "rows" in r else {})})
    return out


def _is_cuda(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def split_profile(events, start_us: Optional[float] = None, end_us: Optional[float] = None) -> Dict:
    """The device's idle time, the launch calls and the kernels' time of a
    ``torch.profiler`` run (its ``events()``), put down to the program's
    spans (the host side of its ``mvkp.*`` ranges), over the window
    [``start_us``, ``end_us``] (default: from the first range's start to
    the last range's or device record's end):

      * ``idle_ms``: each interval in which no kernel, copy or fill ran on
        the device, cut at the ranges' edges, each piece to the innermost
        range open on the host then (``outside`` where none was);
      * ``launches``: each call (once, where CUPTI records it twice) that a
        kernel, copy or fill on the device answers (the same correlation
        id), to the innermost range open when the host made it;
      * ``kernel_ms``: each such record's device time, to its call's range.

    Each is given ``self`` (by innermost range; the parts add up to the
    whole) and ``total`` (by every range open: a span with its children).
    Also ``window_ms``, ``busy_ms`` (the union of the device records) and
    ``steps`` (the ``step`` ranges that start in the window)."""
    host = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):]) for e in events
            if e.name.startswith(PREFIX) and not _is_cuda(e)]
    # the device's kernels, copies and fills, not the ranges' device-side annotations
    device = [e for e in events if _is_cuda(e) and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(PREFIX)]
    if start_us is None:
        start_us = min((s for s, _, _ in host), default=0.0)
    if end_us is None:
        end_us = max([e for _, e, _ in host] + [e.time_range.end for e in device], default=start_us)
    busy, end = [], None
    for s, e in sorted((max(d.time_range.start, start_us), min(d.time_range.end, end_us)) for d in device):
        if e <= s:
            continue
        if end is None or s > end:
            busy.append([s, e])
        elif e > end:
            busy[-1][1] = e
        end = busy[-1][1]
    edges = [start_us] + [x for b in busy for x in b] + [end_us]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    device_us = defaultdict(float)
    for d in device:
        device_us[d.id] += d.time_range.end - d.time_range.start
    # CUPTI may record one call at two API levels under one id: the first counts
    made = {}
    for e in events:
        if (not _is_cuda(e) and e.name.startswith("cu") and e.id in device_us
                and start_us <= e.time_range.start < end_us):
            made[e.id] = min(made.get(e.id, e.time_range.start), e.time_range.start)
    calls = [(t, device_us[i]) for i, t in made.items()]
    # a sweep over the ranges' edges, the idle intervals' edges and the calls;
    # at one instant ranges close (the inner first) before they open (the
    # outer first), and calls come last
    marks = []
    for i, (s, e, _) in enumerate(host):
        marks.append((s, 1, -e, "open", i))
        marks.append((e, 0, -s, "close", i))
    for s, e in idle:
        marks.append((s, 1, 0.0, "idle", True))
        marks.append((e, 0, 0.0, "idle", False))
    for t, us in calls:
        marks.append((t, 2, 0.0, "call", us))
    marks.sort(key=lambda m: m[:3])
    tables = {k: {"self": defaultdict(float), "total": defaultdict(float)} for k in ("idle_ms", "launches", "kernel_ms")}

    def add(table, open_, value):
        tables[table]["self"][host[open_[-1]][2] if open_ else OUTSIDE] += value
        for name in {host[i][2] for i in open_}:
            tables[table]["total"][name] += value

    open_, idling, last = [], False, None
    for t, _, _, kind, what in marks:
        if idling and t > last:
            add("idle_ms", open_, (min(t, end_us) - max(last, start_us)) / 1e3)
        last = t
        if kind == "open":
            open_.append(what)
        elif kind == "close":
            open_.remove(what)
        elif kind == "idle":
            idling = what
        else:
            add("launches", open_, 1)
            add("kernel_ms", open_, what / 1e3)
    out = {k: {part: dict(v) for part, v in t.items()} for k, t in tables.items()}
    out.update(window_ms=(end_us - start_us) / 1e3, busy_ms=sum(e - s for s, e in busy) / 1e3,
               steps=sum(1 for s, _, name in host if name == "step" and start_us <= s < end_us))
    return out
