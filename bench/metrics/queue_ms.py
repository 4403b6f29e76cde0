"""Median, over the requests submitted inside the window, of the time from
a request's submit to the start of its batch's launch (its
``serving.request`` span to its parent's ``serving.launch``): the queue and
the batching window, before the card is asked for anything."""
import numpy as np

from bench.yardstick import spanlog


def read(run):
    got = spanlog.spans_since(run.window.t0)
    if got is None:
        return None
    launch = {(s.session, s.id): s.t0 for s in got
              if s.name == "serving.launch"}
    waits = [launch[(s.session, s.parent)] - s.t0
             for s in spanlog.in_window(run, got, "serving.request")
             if (s.session, s.parent) in launch]
    return float(np.median(waits)) * 1e3 if waits else None
