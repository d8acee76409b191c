"""What the metric readers (``metrics/<name>.py``) share: each takes the run
record (``harness.run_cell``) and returns its number, or None where the run
has nothing to read (another kind of step, no trace, no device time)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def mean_span(run: Dict, span: str, kind: str) -> Optional[float]:
    """Mean ms a step of a traced run's span."""
    values = run.get("spans", {}).get(span) if run["kind"] == kind else None
    return float(np.mean(values)) if values else None


def program_span_ms(run: Dict, span: str, kind: str) -> Optional[float]:
    """Mean device ms a step of one of the program's own spans (``mvkp``
    spans of ``mvkpconv_tpu_torch.tracing``, by its CUDA events), over the
    traced run's pass over the pool (``harness.program_spans``)."""
    values = run.get("program", {}).get("span_ms", {}).get(span) if run["kind"] == kind else None
    return float(np.mean(values)) if values else None


def program_launches(run: Dict, span: str, kind: str) -> Optional[Dict[str, float]]:
    """Mean hand-written-kernel launches a step inside one of the program's
    spans, by the tracer's counter deltas: {counter: launches} (K1's
    ``radius_topk`` counts calls, ``radius_topk_device`` its launches)."""
    steps = run.get("program", {}).get("launches", {}).get(span) if run["kind"] == kind else None
    if not steps:
        return None
    return {k: sum(s.get(k, 0) for s in steps) / len(steps) for k in sorted(set().union(*steps))}


def idle_percent(run: Dict, kind: str) -> Optional[float]:
    """Share of the profiled stretch in which nothing ran on the device."""
    prof = run.get("profile") if run["kind"] == kind else None
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu_percent(run: Dict, kind: str) -> Optional[float]:
    """The window's steps' least time at the published peaks of the
    precisions they ran at (counting.py) over the window's time."""
    counts = run.get("counts") if run["kind"] == kind else None
    if not counts or run["window_s"] <= 0:
        return None
    return 100.0 * counts["peak_seconds"] / run["window_s"]
