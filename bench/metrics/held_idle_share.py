"""Share of the window in which the session held an open batch while its
slot pool held none (the union of its ``serving.hold`` spans): the card
waits on the batching window, not on the arrivals."""
from bench.yardstick import spanlog


def read(run):
    got = spanlog.spans_since(run.window.t0)
    if got is None or not spanlog.in_window(run, got, "serving.admit"):
        return None
    holds = [(s.t0, s.t1) for s in got if s.name == "serving.hold"]
    return 100.0 * spanlog.union_s(holds, run.window.t0,
                                   run.t_end) / run.seconds
