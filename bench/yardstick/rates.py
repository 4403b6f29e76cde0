"""Rates and shares that several metrics read, each from one formula."""
from __future__ import annotations

from bench.yardstick import peaks, work


def images_in_window_per_s(run) -> float | None:
    """Images whose logits came back inside the window, over its length
    (closed loops only: an open loop's rate is the one it offered). Where
    the traffic dispatches work ahead (``slots``), the window closes when
    the last request sent is answered: every image answered counts, over
    the time from the window's opening to that last answer."""
    w = run.window
    if w.due is not None:
        return None
    ok = w.sent("ok")
    if "slots" in run.traffic:
        done = w.sent("t_done")[ok]
        if not len(done):
            return None
        return float(w.sent("count")[ok].sum()) / (float(done.max()) - w.t0)
    inside = ok & (w.sent("t_done") <= run.t_end)
    return float(w.sent("count")[inside].sum()) / run.seconds


def launches_per_image(run) -> float | None:
    """Kernel launches of the window's requests (a CUDA graph's launches
    counted at every replay), per image answered."""
    w = run.window
    images = int(w.sent("count")[w.sent("ok")].sum())
    launches = sum(run.launches.values())
    return launches / images if images and launches else None


def mfu_in_slice(run) -> float | None:
    """Percent: counted FLOPs of the images answered inside the traced
    slice, over the slice's length times the TF32 peak."""
    if run.slice_t is None:
        return None
    t0, t1 = run.slice_t
    w = run.segment
    done = w.sent("t_done")
    images = int(w.sent("count")[w.sent("ok") & (done >= t0)
                                 & (done <= t1)].sum())
    flops = images * work.flops_per_image(run.layers)
    return 100.0 * flops / ((t1 - t0) * peaks.TF32_FLOPS) if images else None


def mfu_of_busy(run) -> float | None:
    """Percent: counted FLOPs of the images sent to the card inside the
    traced slice, over the card's busy time in it times the TF32 peak."""
    if run.trace is None or not run.slice_rows:
        return None
    flops = run.slice_rows * work.flops_per_image(run.layers)
    return 100.0 * flops / (run.trace["busy_s"] * peaks.TF32_FLOPS)


def idle_share(run) -> float | None:
    """Percent of the traced slice in which no operation ran on the card."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
