"""Activation-range observers for post-training calibration.

Both produce a per-tensor symmetric scale in the ``optim.compression``
convention (``scale = amax / 127``, zero point 0); ``MinMaxObserver``
reuses ``compression.quantize_int8``. Both take a host copy of what they
observe (a tensor on any device, or an array) and compute in numpy, as the
reference does, so equal inputs give equal scales bit for bit.
``torch.quantile`` is not an option: it refuses inputs above 2**24
elements, and VGG16's first conv output at batch 8 holds 25.7 million.
"""
from __future__ import annotations

import numpy as np

from repro_torch.compat import to_numpy
from repro_torch.optim.compression import quantize_int8


class MinMaxObserver:
    """Running |max| over every observed batch (no clipping, widest
    scale)."""

    def __init__(self) -> None:
        self._scale = 0.0

    def observe(self, x) -> None:
        _, scale = quantize_int8(to_numpy(x))
        self._scale = max(self._scale, float(scale))

    @property
    def scale(self) -> float:
        if self._scale <= 0.0:
            raise ValueError("observer saw no data — calibrate first")
        return self._scale


class PercentileObserver:
    """Per-batch |x| percentile, running max across batches: clips the far
    tail so the 254 usable int8 codes cover the bulk of the range."""

    def __init__(self, pct: float = 99.9) -> None:
        if not 0.0 < pct <= 100.0:
            raise ValueError(f"pct must be in (0, 100], got {pct}")
        self.pct = pct
        self._amax = 0.0

    def observe(self, x) -> None:
        a = np.abs(np.asarray(to_numpy(x), np.float32))
        self._amax = max(self._amax, float(np.percentile(a, self.pct)))

    @property
    def scale(self) -> float:
        if self._amax <= 0.0:
            raise ValueError("observer saw no data — calibrate first")
        return (self._amax + 1e-12) / 127.0


def make_observer(kind: str):
    if kind == "minmax":
        return MinMaxObserver()
    if kind == "percentile":
        return PercentileObserver()
    raise ValueError(f"unknown observer {kind!r} (want 'minmax' or "
                     f"'percentile')")
