"""The program's span log (``repro_torch.spans.LOG``) as the per-layer
metrics read it: each span has a ``name``, its ``t0`` and ``t1`` on the
host clock of the window (``time.perf_counter``), an ``id``, a
``parent``, a ``session`` and a ``count``. A program that keeps no span
log, or a log that no longer holds the start of what a metric reads,
gives nothing to read, never a part of it."""
from __future__ import annotations

import math


def spans_since(t0: float) -> list | None:
    """Every span the program logged that ended at or after ``t0``, by
    start; None where the program has no span log or it no longer holds
    ``t0``."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.LOG.between(t0, math.inf)


def in_window(run, got: list, name: str) -> list:
    """The spans of ``got`` named ``name`` that began inside the window."""
    lo, hi = run.window.t0, run.t_end
    return [s for s in got if s.name == name and lo <= s.t0 <= hi]


def union_s(intervals, t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` covered by the union of ``intervals``."""
    total, reach = 0.0, t0
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, t1)
        if b > a:
            total += b - a
            reach = b
    return total
