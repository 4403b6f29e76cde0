"""Median latency of every request due in the window, from its due time to
its result (open-loop cells); a failed request counts as never answered."""
from bench.yardstick import latency


def read(run):
    return latency.due_time_percentile(run, 50)
