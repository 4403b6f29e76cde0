"""Host seconds of the run's design-space exploration inside
``Accelerator.build`` (the newest ``build.dse`` span that ended before the
window opened)."""
from bench.yardstick import spanlog


def read(run):
    got = spanlog.spans_since(run.window.t0 - run.setup_s)
    if got is None:
        return None
    dse = [s for s in got if s.name == "build.dse" and s.t1 <= run.window.t0]
    if not dse:
        return None
    last = max(dse, key=lambda s: s.t1)
    return last.t1 - last.t0
