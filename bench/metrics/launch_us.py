"""Median host microseconds of the window's batch launches (its
``serving.launch`` spans: the copy in enqueued, the graph replayed, the
logits cloned, their copy out enqueued and an event recorded)."""
import numpy as np

from bench.yardstick import spanlog


def read(run):
    got = spanlog.spans_since(run.window.t0)
    if got is None:
        return None
    us = [(s.t1 - s.t0) * 1e6
          for s in spanlog.in_window(run, got, "serving.launch")]
    return float(np.median(us)) if us else None
