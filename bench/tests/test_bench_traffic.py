"""The traffic generator, the due-time latency and the percentiles."""
import math
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from bench.yardstick import latency, stats, traffic


ONLINE = {"arrival": "poisson", "rate_per_s": 500, "images_per_request": 1,
          "single": True, "buckets": [1]}


def test_every_seed_gets_the_same_gaps_in_another_order():
    a = traffic.schedule(ONLINE, 4.0, 2 ** 31 + 12345)
    b = traffic.schedule(ONLINE, 4.0, 7)
    assert len(a) == len(b) == 2000
    assert a[-1] == pytest.approx(4.0) and b[-1] == pytest.approx(4.0)
    gaps_a, gaps_b = np.diff(a, prepend=0.0), np.diff(b, prepend=0.0)
    np.testing.assert_allclose(np.sort(gaps_a), np.sort(gaps_b),
                               rtol=1e-6, atol=1e-9)
    assert not np.allclose(gaps_a, gaps_b)
    np.testing.assert_array_equal(a, traffic.schedule(ONLINE, 4.0,
                                                      2 ** 31 + 12345))
    assert np.all(np.diff(a) > 0)
    # every second offers the same load
    per_s = np.histogram(a, bins=4, range=(0, 4.0))[0]
    assert per_s.max() - per_s.min() <= 2


def test_closed_plan_cycles_one_seeded_set():
    tr = {"arrival": "closed", "outstanding": 4, "images_per_request": 8}
    w = traffic.plan_closed(tr, 1.0, 5, pool=256)
    assert len(w.start) == traffic.CLOSED_PER_S
    assert np.all(w.count == 8) and np.all(w.start <= 248)
    np.testing.assert_array_equal(
        w.start[:traffic.CLOSED_CYCLE],
        w.start[traffic.CLOSED_CYCLE:2 * traffic.CLOSED_CYCLE])


class StallingSession:
    """Answers each request ``service_s`` after it is submitted, on a
    thread of its own; ``submit`` blocks for ``stall_s`` once, at the
    ``stall_at``-th request."""

    def __init__(self, service_s=0.002, stall_at=None, stall_s=0.0):
        self.service_s, self.stall_at, self.stall_s = \
            service_s, stall_at, stall_s
        self.n = 0

    def submit(self, x):
        if self.n == self.stall_at:
            time.sleep(self.stall_s)
        self.n += 1
        fut = Future()
        threading.Timer(self.service_s, fut.set_result,
                        (np.asarray(x).reshape(-1)[:4].copy(),)).start()
        return fut


def test_due_time_latency_counts_a_stall():
    images = np.zeros((16, 2, 2, 1), np.float32)
    tr = dict(ONLINE, rate_per_s=200)
    w = traffic.plan_open(tr, 1.0, 1, pool=16)
    traffic.run_open(StallingSession(stall_at=100, stall_s=0.2), images, w)
    assert w.n == 200 and w.ok.all()
    lat = latency.due_time_ms(w)
    from_submit = (w.t_done - w.t_submit) * 1e3
    # the requests due during the stall (inside request 100's submit) wait
    # for it: timed from the due time they are late, timed from their
    # submit they are not
    assert lat[100] >= 195
    assert (lat[101:] > 50).sum() >= 20
    assert np.delete(from_submit, 100).max() < 50
    assert stats.percentile(lat, 95) > 50 > stats.percentile(from_submit, 95)


def test_failed_requests_miss_every_limit():
    class Failing(StallingSession):
        def submit(self, x):
            fut = Future()
            fut.set_exception(RuntimeError("boom"))
            return fut
    images = np.zeros((16, 2, 2, 1), np.float32)
    w = traffic.plan_open(dict(ONLINE, rate_per_s=100), 0.2, 1, pool=16)
    traffic.run_open(Failing(), images, w)
    assert not w.ok.any()
    assert np.isinf(latency.due_time_ms(w)).all()


def test_closed_loop_keeps_its_requests_in_flight():
    images = np.zeros((16, 2, 2, 1), np.float32)
    tr = {"arrival": "closed", "outstanding": 3, "images_per_request": 2,
          "single": False}
    w = traffic.plan_closed(tr, 0.3, 2, pool=16)
    traffic.run_closed(StallingSession(service_s=0.01), images, w, 3, 0.3)
    assert 60 <= w.n <= 95
    assert w.sent("ok").all()
    assert w.hi.shape == (16, 4) and w.seen.any()


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([3.0, math.inf], 50) == 3.0
    assert stats.percentile([3.0, math.inf], 95) == math.inf


def _closed_run(traffic_extra: dict):
    """A closed loop's record of four requests of two images, the window
    opening at 10 s and lasting 1 s; the last answer comes at 11.5 s."""
    import types
    w = traffic.Window(np.zeros(4, np.int64), np.full(4, 2, np.int64),
                       False, 8)
    w.t0, w.n = 10.0, 4
    w.t_done[:] = [10.2, 10.6, 10.9, 11.5]
    w.ok[:] = True
    tr = dict({"arrival": "closed", "outstanding": 2,
               "images_per_request": 2}, **traffic_extra)
    return types.SimpleNamespace(window=w, traffic=tr, seconds=1.0,
                                 t_end=11.0)


@pytest.mark.parametrize("extra, rate", [({}, 6.0), ({"slots": 2}, 8 / 1.5)])
def test_closed_loop_rate_over_its_window(extra, rate):
    """Without ``slots`` the answers inside the window count, over its
    length; with them, every answer counts, over the time to the last."""
    from bench.yardstick import rates
    assert rates.images_in_window_per_s(_closed_run(extra)) == \
        pytest.approx(rate)


def test_slots_set_the_sessions_pipeline_and_each_is_filled():
    from bench import harness
    assert harness._pipeline({"buckets": [8]}) == {}
    pool = harness._pipeline({"slots": 5})["slot_pool"]
    assert pool.capacity == 5

    class Session:
        def __init__(self):
            self.sent = []

        def submit_many(self, xs):
            self.sent += xs
            futs = [Future() for _ in xs]
            for f in futs:
                f.set_result(np.asarray(xs[0]).reshape(len(xs[0]), -1))
            return futs
    images = np.arange(16 * 4, dtype=np.float32).reshape(16, 2, 2, 1)
    s = Session()
    w = traffic.Window(np.zeros(1, np.int64), np.ones(1, np.int64), False,
                       16)
    harness._fill(s, images, {"images_per_request": 3, "slots": 5}, w)
    assert len(s.sent) == 5 and all(x.shape == (3, 2, 2, 1) for x in s.sent)
    # the answers are folded in to be compared with the window's
    assert w.seen.tolist() == [True] * 3 + [False] * 13
    assert np.array_equal(w.hi[:3], images[:3].reshape(3, 4))
    s = Session()
    harness._fill(s, images, {"images_per_request": 3}, w)
    assert s.sent == []
