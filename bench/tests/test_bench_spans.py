"""The readers of the program's span log (``queue_ms``,
``held_idle_share``, ``launch_us``, ``dse_s``): their values over a log
that holds the window, and nothing where the log no longer holds it or the
program keeps none."""
import sys

import numpy as np
import pytest

from bench import harness
from bench.yardstick import traffic
from bench_tiny import ROOT

READERS = ["queue_ms.online", "held_idle_share.online", "launch_us.online",
           "launch_us.bulk", "dse_s"]


def _run(t0=100.0, seconds=1.0, setup_s=10.0):
    w = traffic.Window(np.array([0]), np.array([1]), True, 1)
    w.t0 = t0
    return harness.Run(config={}, traffic={}, seconds=seconds, window=w,
                       setup_s=setup_s, build_s=0.0, capture_s=0.0, stats={},
                       launches={})


def _log(capacity=64):
    """A log of one build before the window and two batches of two
    requests inside it, the first held idle for 4 ms."""
    from repro_torch import spans
    log = spans.SpanLog(capacity)
    log.record("build.dse", 91.0, 91.25, 1, 0)
    log.record("serving.admit", 100.1, 100.106, 0, -1, 3, 2)
    log.record("serving.hold", 100.102, 100.106, 0, -1, 3)
    log.record("serving.launch", 100.107, 100.10705, 0, -1, 3, 2)
    log.record("serving.admit", 100.5, 100.501, 1, -1, 3, 2)
    log.record("serving.launch", 100.502, 100.50203, 1, -1, 3, 2)
    for rid, (t0, bid) in enumerate([(100.1, 0), (100.103, 0),
                                     (100.5, 1), (100.5005, 1)]):
        log.record("serving.request", t0, t0 + 0.01, rid, bid, 3, 1)
    return log


def _read(name, run):
    return harness._reader(name, ROOT)(run)


def test_the_readers_over_a_log_that_holds_the_window(monkeypatch):
    from repro_torch import spans
    monkeypatch.setattr(spans, "LOG", _log())
    run = _run()
    # submit -> launch: 7, 4, 2 and 1.5 ms
    assert _read("queue_ms.online", run) == pytest.approx(3.0)
    assert _read("held_idle_share.online", run) == pytest.approx(0.4)
    assert _read("launch_us.online", run) == pytest.approx(40.0)
    assert _read("launch_us.bulk", run) == pytest.approx(40.0)
    assert _read("dse_s", run) == pytest.approx(0.25)


@pytest.mark.parametrize("name", READERS)
def test_nothing_is_read_from_a_log_that_lost_the_window(monkeypatch, name):
    from repro_torch import spans
    log = _log(capacity=16)
    for i in range(16):     # a later session overwrites every span
        log.record("serving.launch", 102.0 + i, 102.0 + i + 1e-5, i, -1, 4)
    monkeypatch.setattr(spans, "LOG", log)
    assert not log.holds(100.0)
    assert _read(name, _run()) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_is_read_from_a_program_without_a_span_log(monkeypatch,
                                                          name):
    import repro_torch
    from repro_torch import spans
    monkeypatch.setattr(spans, "LOG", _log())
    assert _read(name, _run()) is not None
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert _read(name, _run()) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_is_read_from_an_empty_window(monkeypatch, name):
    from repro_torch import spans
    monkeypatch.setattr(spans, "LOG", _log())
    assert _read(name, _run(t0=200.0, setup_s=5.0)) is None
