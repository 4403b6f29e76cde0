"""The comparison that decides ``correct``.

Every answer of the window is held to the plain reference's logits for the
same images (``window_gap``): its gap is the largest absolute difference over its logits
divided by the largest absolute reference logit of that image, and the
number compared is the widest gap over every answered image. A request
that failed or never came counts in ``answers_missing``, whose limit is 0.
A NaN gap fails."""
from __future__ import annotations

import math

import numpy as np


def logit_gap(answers: np.ndarray, refs: np.ndarray) -> float:
    """Widest per-image gap of ``answers`` (n, classes) from ``refs``."""
    if answers.shape != refs.shape:
        raise ValueError(f"answers {answers.shape} against refs {refs.shape}")
    if answers.size == 0:
        return 0.0
    diff = np.abs(answers.astype(np.float64) - refs.astype(np.float64))
    scale = np.abs(refs.astype(np.float64)).max(axis=1)
    gaps = diff.max(axis=1) / np.maximum(scale, np.finfo(np.float32).tiny)
    if np.isnan(gaps).any():
        return math.nan
    return float(gaps.max())


def window_gap(w, refs: np.ndarray) -> float:
    """Widest gap of every answer of the window ``w`` (``traffic.Window``)
    from the reference's logits ``refs`` of the pool: for each logit the
    answer farthest from the reference is the lowest or the highest one
    seen for its image."""
    if w.hi is None:
        return 0.0
    seen = w.seen
    gaps = [logit_gap(w.hi[seen], refs[seen]),
            logit_gap(w.lo[seen], refs[seen])]
    return math.nan if any(map(math.isnan, gaps)) else max(gaps)


def checks(gap: float, missing: int, gap_limit: float) -> dict:
    """Each number compared beside its limit."""
    return {"logit_gap": {"value": gap, "limit": gap_limit},
            "answers_missing": {"value": missing, "limit": 0}}


def passed(chk: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())
