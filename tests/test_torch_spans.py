"""The port's span log (``repro_torch.spans``) and the spans a
``ServingSession`` and ``Accelerator.build`` record in it, on the CPU.

Every request answered has one ``serving.request`` span whose parent is a
batch, and that batch's spans follow each other in time; the log's clock
is the session's and the harness's; a wrapped log reports nothing for an
interval it no longer holds; an idle session's batching window shows as
its batch's idle hold; no profiler range is opened while nothing records,
and under a profiler of every thread the session's ranges land on the
worker and drain threads at the log's times."""
import json
import math
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, spans  # noqa: E402
from repro_torch.core import perf_model as pm  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec, FCSpec  # noqa: E402
from repro_torch.core.hybrid_conv import PoolSpec  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402

SPECS = [ConvSpec("c1", 8, 8, 3, 4), PoolSpec("p1", 8, 8, 4),
         FCSpec("fc", 4 * 4 * 4, 10, relu=False)]
BATCH_SPANS = (spans.ADMIT, spans.SLOT, spans.STAGE, spans.LAUNCH,
               spans.DRAIN, spans.DELIVER)
TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def acc():
    return api.Accelerator.build(SPECS, pm.V5E, batch=4, seed=0,
                                 device="cpu", cache=ProgramCache())


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((8, 8, 3)).astype(np.float32)
            for _ in range(n)]


def _serve(acc, images, gap_s=0.0, **kw):
    """Submit ``images`` one by one, ``gap_s`` apart; returns the session
    (closed) and the window ``(t0, t1)`` around it on the span clock."""
    session = acc.serve(max_batch=4, buckets=(1, 2, 4), **kw)
    try:
        t0 = spans.clock()
        futs = []
        for x in images:
            futs.append(session.submit(x))
            time.sleep(gap_s)
        for f in futs:
            f.result(timeout=TIMEOUT_S)
        t1 = spans.clock()
    finally:
        session.close()
    return session, t0, t1


def _by_batch(session, t0):
    got = [s for s in spans.LOG.between(t0)
           if s.session == session.stats.session]
    batches, requests = {}, []
    for s in got:
        if s.name == spans.REQUEST:
            requests.append(s)
        elif s.name != spans.AWAIT:
            batches.setdefault(s.id, {})[s.name] = s
    return batches, requests


def test_every_request_has_a_span_under_a_batch_whose_spans_are_ordered(acc):
    session, t0, _ = _serve(acc, _images(12), gap_s=0.002)
    batches, requests = _by_batch(session, t0)
    assert len(requests) == 12 == session.stats.requests
    assert sorted(r.id for r in requests) == list(range(12))
    assert len(batches) == session.stats.batches
    for r in requests:
        b = batches[r.parent]
        assert r.count == 1 and r.t0 <= b[spans.ADMIT].t1
        ends = [b[name].t0 for name in BATCH_SPANS]
        assert ends == sorted(ends), r
        for a, z in zip(BATCH_SPANS, BATCH_SPANS[1:]):
            assert b[a].t1 <= b[z].t0, (a, z)
        assert b[spans.DRAIN].t1 <= r.t1 <= b[spans.DELIVER].t1
    rows = sum(b[spans.ADMIT].count for b in batches.values())
    assert rows == 12
    assert all(b[spans.STAGE].count == b[spans.LAUNCH].count in (1, 2, 4)
               for b in batches.values())
    assert sum(b[spans.DELIVER].count for b in batches.values()) == 12


def test_percentiles_read_the_session_s_request_spans(acc):
    session, t0, t1 = _serve(acc, _images(8), gap_s=0.001)
    st = session.stats
    _, requests = _by_batch(session, t0)
    lat = sorted((r.t1 - r.t0) * 1e3 for r in requests)
    assert st.p50_ms() == lat[4] and st.p95_ms() == lat[7]
    assert st.p50_ms(t0, t1) == lat[4]
    assert 0.0 <= st.wait_p50_ms() <= st.wait_p95_ms() <= st.p95_ms()
    assert st.p50_ms(t1 + 1.0, t1 + 2.0) == 0.0     # nothing submitted
    assert not hasattr(st, "latencies_ms") and not hasattr(st, "waits_ms")


def test_the_log_s_clock_is_the_session_s_and_perf_counter(acc):
    info_p = time.get_clock_info("perf_counter")
    info_m = time.get_clock_info("monotonic")
    if sys.platform.startswith("linux"):
        assert info_p.implementation == info_m.implementation \
            == "clock_gettime(CLOCK_MONOTONIC)"
    assert spans.clock is time.perf_counter
    a = time.perf_counter()
    m = time.monotonic()
    b = time.perf_counter()
    assert a <= m <= b
    session = acc.serve(max_batch=4, buckets=(1, 2, 4))
    try:
        before = time.perf_counter()
        session.submit(_images(1)[0]).result(timeout=TIMEOUT_S)
        after = time.perf_counter()
    finally:
        session.close()
    _, requests = _by_batch(session, before)
    (r,) = requests
    assert before <= r.t0 <= r.t1 <= after


def test_a_wrapped_log_reports_nothing_for_an_interval_it_lost():
    log = spans.SpanLog(capacity=8)
    for i in range(8):
        log.record(spans.LAUNCH, float(i), i + 0.5, i)
    assert [s.id for s in log.between(0.0)] == list(range(8))
    log.record(spans.LAUNCH, 8.0, 8.5, 8)     # overwrites span 0
    assert log.between(0.0) is None and log.between(0.5) is None
    assert not log.holds(0.5) and log.holds(0.6)
    assert [s.id for s in log.between(0.6)] == list(range(1, 9))
    assert [s.id for s in log.between(3.0, 4.2)] == [3, 4]
    assert len(log.between()) == 8
    with pytest.raises(ValueError):
        spans.SpanLog(capacity=6)


def test_the_default_log_holds_the_busiest_cell_s_window():
    # about 147k spans over the online cell's window and traced segment
    assert spans.LOG.capacity == spans.CAPACITY >= 1.5 * 147_000


@pytest.mark.parametrize("max_wait_ms, least, most", [(20.0, 15.0, None),
                                                      (0.0, None, 2.0)])
def test_a_lone_request_s_idle_hold_is_the_batching_window(acc, max_wait_ms,
                                                           least, most):
    session, t0, _ = _serve(acc, _images(1), max_wait_ms=max_wait_ms)
    batches, requests = _by_batch(session, t0)
    (r,) = requests
    b = batches[r.parent]
    hold = b.get(spans.HOLD)
    hold_ms = 0.0 if hold is None else (hold.t1 - hold.t0) * 1e3
    if least is not None:
        assert hold_ms >= least
        assert b[spans.ADMIT].t0 <= hold.t0 <= hold.t1 <= b[spans.ADMIT].t1
    if most is not None:
        assert hold_ms <= most


def test_no_profiler_range_is_opened_while_nothing_records(acc, monkeypatch):
    opened = []

    class Counting:
        def __init__(self, name, *a):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans._profiler, "record_function", Counting)
    assert not spans.on()
    _serve(acc, _images(6), gap_s=0.001)
    assert opened == []
    with spans.recording():
        assert spans.on()
        _serve(acc, _images(2))
    assert not spans.on()
    assert {spans.ADMIT, spans.STAGE, spans.LAUNCH, spans.DELIVER} \
        <= set(opened)
    assert spans.DRAIN not in opened and spans.REQUEST not in opened


def test_profiler_ranges_land_on_the_worker_and_drain_threads(acc, tmp_path):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        session, t0, _ = _serve(acc, _images(6), gap_s=0.003)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("serving.")]
    logged = [s for s in spans.LOG.between(t0)
              if s.session == session.stats.session]
    tids = {}
    offsets = []
    for name in (spans.ADMIT, spans.STAGE, spans.LAUNCH, spans.DELIVER):
        got = sorted(e["ts"] for e in events if e["name"] == name)
        want = sorted(s.t0 for s in logged if s.name == name)
        assert len(got) == len(want) > 0, name
        offsets += [g - w * 1e6 for g, w in zip(got, want)]
        tids[name] = {e["tid"] for e in events if e["name"] == name}
    assert max(offsets) - min(offsets) <= 500.0       # us
    assert tids[spans.ADMIT] == tids[spans.LAUNCH]
    assert len(tids[spans.ADMIT]) == 1 and len(tids[spans.DELIVER]) == 1
    assert tids[spans.ADMIT] != tids[spans.DELIVER]
    assert not any(e["name"] in (spans.DRAIN, spans.REQUEST)
                   for e in events)


def test_a_build_records_its_steps_under_one_span():
    t0 = spans.clock()
    api.Accelerator.build(SPECS, pm.V5E, batch=2, seed=1, device="cpu",
                          cache=ProgramCache())
    got = [s for s in spans.LOG.between(t0) if s.name.startswith("build")]
    (build,) = [s for s in got if s.name == spans.BUILD]
    assert build.count == 2 and build.parent == -1
    children = {s.name: s for s in got if s.parent == build.id}
    assert set(children) == {spans.BUILD_DSE, spans.BUILD_COMPILE,
                             spans.BUILD_LOAD, spans.BUILD_VALIDATE}
    order = [children[n] for n in (spans.BUILD_DSE, spans.BUILD_COMPILE,
                                   spans.BUILD_LOAD, spans.BUILD_VALIDATE)]
    for a, z in zip(order, order[1:]):
        assert a.t1 <= z.t0
    assert build.t0 <= order[0].t0 and order[-1].t1 <= build.t1


def test_the_union_of_intervals_inside_a_window():
    from repro_torch.serving.trace import union_s
    assert union_s([(0, 2), (1, 3), (5, 6), (-1, 0.5)], 0.0, 5.5) \
        == pytest.approx(3.5)
    assert union_s([], 0.0, 1.0) == 0.0


def test_percentiles_of_an_interval_the_log_lost_are_nan(monkeypatch):
    log = spans.SpanLog(capacity=4)
    for i in range(6):
        log.record(spans.REQUEST, float(i), i + 0.25, i, 0, 7, 1)
    monkeypatch.setattr(spans, "LOG", log)
    st = api.SessionStats(session=7)
    assert math.isnan(st.p50_ms(0.0, 10.0))
    assert math.isnan(st.wait_p95_ms(1.0, 10.0))
    assert st.p50_ms(2.5, 10.0) == 250.0
    assert st.p50_ms() == 250.0           # what the log still holds


def test_a_span_overwritten_by_racing_threads_is_never_reported_held():
    """Sixteen threads record into a small ring under a short switch
    interval: every span the ring no longer holds ended no later than the
    mark readers check, so no reader takes a partial interval for whole."""
    import threading
    log = spans.SpanLog(capacity=64)
    mine = [[] for _ in range(16)]

    def work(k):
        for i in range(2000):
            t = spans.clock()
            log.record(spans.LAUNCH, t, t, k * 10_000 + i)
            mine[k].append((k * 10_000 + i, t))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    held = {s.id for s in log.between()}
    assert len(held) == 64
    for sid, t in (x for m in mine for x in m):
        if sid not in held:
            assert not log.holds(t), sid
