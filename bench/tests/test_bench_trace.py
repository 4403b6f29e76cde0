"""The reduction of a profiler trace, the roofline and idle shares read
from it, and the sweep's row."""
import types

import numpy as np
import pytest

from bench.yardstick import rates, trace, traffic, work

IMAGE = 4 * 2 * 2 * 1


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    return {"traceEvents": [
        _x("user_annotation", trace.SLICE_START, 1000, 1),
        _x("user_annotation", trace.SLICE_END, 11000, 1),
        _x("user_annotation", "ProfilerStep#1", 900, 10200),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1000, 100,
           bytes=2 * IMAGE),
        _x("kernel", "gemm", 1100, 1900),
        _x("kernel", "pool", 3000, 1000),
        _x("cuda_runtime", "cudaGraphLaunch", 4100, 800),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 5000, 100,
           bytes=IMAGE),
        _x("kernel", "gemm", 5100, 900),
        _x("cuda_runtime", "cudaEventSynchronize", 6000, 2000),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 8000, 100,
           bytes=8 * IMAGE),
        _x("kernel", "gemm", 8100, 1900),
        _x("kernel", "before", 0, 500),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1000},
    ]}


def test_reduce():
    got = trace.reduce(_trace(), image_bytes=IMAGE,
                       pauses_us=[(6000.0, 8000.0, 0)])
    assert got["window_s"] == pytest.approx(0.01)
    assert got["busy_s"] == pytest.approx(0.006)
    assert got["buckets"] == [2, 1]
    assert got["kernel_s"] == pytest.approx(0.0038)
    assert got["device_ops"][0] == ["gemm", pytest.approx(0.0047)]
    assert [g[0] for g in got["idle_gaps"]] == [
        "gc pause, generation 0", "host in cudaGraphLaunch",
        "no traced host call"]
    assert [g[1] for g in got["idle_gaps"]] == pytest.approx(
        [0.002, 0.001, 0.001])


def test_reduce_without_markers_or_device_ops():
    t = _trace()
    assert trace.reduce({"traceEvents": t["traceEvents"][2:]},
                        image_bytes=IMAGE) is None
    assert trace.reduce({"traceEvents": t["traceEvents"][:3]},
                        image_bytes=IMAGE) is None


def test_shares_read_from_the_trace():
    layers = [dict(kind="fc", name="f", d_in=2 * 2 * 1, d_out=3, relu=False)]
    red = trace.reduce(_trace(), image_bytes=IMAGE)
    run = types.SimpleNamespace(trace=red, layers=layers, slice_rows=11,
                                slice_t=None)
    share = work.roofline_share(run)
    assert share == pytest.approx(
        100 * (work.bound_s(layers, 2) + work.bound_s(layers, 1)) / 0.0038)
    assert rates.idle_share(run) == pytest.approx(40.0)
    assert rates.mfu_of_busy(run) == pytest.approx(
        100 * 11 * 24 / (0.006 * 494.7e12))
    assert rates.mfu_in_slice(run) is None
    assert work.roofline_share(types.SimpleNamespace(trace=None)) is None


def test_sweep_row():
    from bench import sweep
    w = traffic.Window(np.zeros(4, np.int64), np.ones(4, np.int64), True, 1,
                       np.array([0.25, 0.5, 0.75, 1.0]))
    w.t0, w.n = 10.0, 4
    w.t_submit[:] = 10.0 + w.due
    w.t_done[:] = w.t_submit + [0.01, 0.02, 0.6, 0.7]
    w.ok[:] = True
    row = sweep.window_row(4.0, 1.0, w, max_batch=8)
    assert row["offered_per_s"] == pytest.approx(4.0)
    assert row["served_per_s"] == pytest.approx(4 / 1.7)
    assert row["backlog_growth_per_s"] == pytest.approx((2 - 1) / 0.5)
    assert row["latency_p95_ms"] == pytest.approx(700)
    assert not row["sustained"]         # served 59 % of what was offered
    w.t_done[:] = w.t_submit + 0.01
    assert sweep.window_row(4.0, 1.0, w, max_batch=8)["sustained"]
    # served in full at the end, but the backlog grew by 50 requests over
    # the second half: more than two batches of 8
    due = np.arange(1, 101) / 100.0
    w = traffic.Window(np.zeros(100, np.int64), np.ones(100, np.int64), True,
                       1, due)
    w.t0, w.n = 10.0, 100
    w.t_submit[:] = 10.0 + due
    w.t_done[:] = np.where(due <= 0.5, w.t_submit + 0.001, 11.005)
    w.ok[:] = True
    row = sweep.window_row(100.0, 1.0, w, max_batch=8)
    assert row["served_per_s"] >= 0.98 * row["offered_per_s"]
    assert row["backlog_growth_per_s"] == pytest.approx(98.0)
    assert not row["sustained"]
