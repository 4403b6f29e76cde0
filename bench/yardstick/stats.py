"""Percentiles as the benchmark reports them."""
from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` % of
    the values at or below it. A failed request enters as ``inf``, so it
    misses every limit."""
    xs = np.sort(np.asarray(values, dtype=np.float64))
    if not len(xs):
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])
