"""Request latency from the due time, over every request of the window."""
from __future__ import annotations

import sys

import numpy as np

from bench.yardstick import stats


def due_time_ms(w) -> np.ndarray:
    """Milliseconds from each request's due time to its result, for every
    request of the open-loop window ``w`` (``traffic.Window``); ``inf``
    where it failed or never came."""
    lat = (w.sent("t_done") - (w.t0 + w.sent("due"))) * 1e3
    lat[~w.sent("ok")] = np.inf
    return lat


def due_time_percentile(run, q: float) -> float | None:
    w = run.window
    if w.due is None or not w.n:
        return None
    lat = due_time_ms(w)
    value = stats.percentile(lat, q)
    beyond = int((lat > value).sum())
    print(f"latency p{q:g}: {value:.4f} ms over {len(lat)} requests, "
          f"{beyond} beyond it", file=sys.stderr)
    return value
