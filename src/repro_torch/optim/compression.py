"""Per-tensor symmetric int8: ``scale = (amax + 1e-12) / 127``, zero point
0, values clipped to [-127, 127].

The reference's ``optim/compression.py`` defines this scheme for its
error-feedback gradient all-reduce, and its calibration observers reuse it.
Only ``quantize_int8`` and ``dequantize_int8`` are ported, in numpy float32
with the reference's arithmetic step for step, so the ``minmax`` observer's
scales match it bit for bit. ``compress_grad`` and the rest wait for the LM
side (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import numpy as np


def quantize_int8(x) -> tuple[np.ndarray, np.float32]:
    """Per-tensor symmetric int8: returns ``(q, scale)``."""
    x = np.asarray(x, np.float32)
    amax = np.float32(np.abs(x).max()) + np.float32(1e-12)
    scale = np.float32(amax / np.float32(127.0))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q, scale) -> np.ndarray:
    return np.asarray(q).astype(np.float32) * np.float32(scale)
