"""The traffic of a cell: which requests it sends, when, and how each is
timed. One generator reads every traffic file (``bench/traffic/*.json``):

- ``arrival``: ``"closed"`` (one client keeps ``outstanding`` requests in
  flight and sends the next as the oldest completes) or ``"poisson"`` (one
  client sends ``rate_per_s`` requests a second on a schedule, whatever the
  session does).
- ``images_per_request``: the images of every request.
- ``single``: each request is one (H, W, C) image rather than a batch.
- ``buckets``: the batch sizes the session serves (and warms up).
- ``slots`` (optional): the device batches the session keeps in flight,
  where the traffic needs more than the session's own three, so that a
  stall of the host does not leave the card without work; the window of
  such a traffic closes when its last request is answered.

Every seed gets the same set of gaps between arrivals, in another order: each second's worth of arrivals (``rate``
of them) takes the midpoint quantiles of the exponential distribution as
its gaps, shuffled by the seed, and the gaps are scaled to fill their
stretch of the window exactly. So every second offers the same load, and
a seed changes only the order of the gaps inside it. A request is timed
from when it was due (open loop) or sent (closed loop) to when its result
was set, and one that fails counts as never answered.

The records are numpy arrays filled in place, and the client keeps no
future once it is resolved: the load generator leaves next to no objects
for the garbage collector, whose pauses would otherwise be its own doing
and not the program's. Nor does it keep the answers: each is folded, as
it arrives, into the elementwise lowest and highest logits seen for its
image of the pool, from which the widest gap of any answer from the
reference follows exactly."""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time

import numpy as np

# how long after the window a request may still come back before it
# counts as never answered
LATE_S = 60.0
# requests a closed loop may send, per second of window
CLOSED_PER_S = 50_000
# the cycle of a closed loop's request sizes and images
CLOSED_CYCLE = 4096


@dataclasses.dataclass(eq=False)
class Window:
    """The requests of one window and what became of each. Request ``i``
    asks for images ``start[i] : start[i] + count[i]`` of the pool of
    ``pool`` images; in an open loop it is due ``due[i]`` seconds after the
    window opens. ``lo`` and ``hi`` hold, per image of the pool, the
    elementwise lowest and highest logits of every answer for it (NaN where
    an answer held one; None until the first answer)."""
    start: np.ndarray
    count: np.ndarray
    single: bool
    pool: int
    due: np.ndarray | None = None
    t0: float = math.nan          # the window opens (perf_counter)
    n: int = 0                    # requests sent
    t_submit: np.ndarray = None
    t_done: np.ndarray = None
    ok: np.ndarray = None         # answered
    lo: np.ndarray | None = None
    hi: np.ndarray | None = None
    seen: np.ndarray = None       # images of the pool answered at least once

    def __post_init__(self):
        size = len(self.start)
        self.t_submit = np.full(size, math.nan)
        self.t_done = np.full(size, math.nan)
        self.ok = np.zeros(size, bool)
        self.seen = np.zeros(self.pool, bool)
        self._lock = threading.Lock()
        self._settled = 0           # requests resolved, answered or not
        self._closed = False        # the client has sent its last request
        self._all = threading.Event()

    def sent(self, name: str) -> np.ndarray:
        """An array field over the requests sent."""
        return getattr(self, name)[:self.n]

    def payload(self, images: np.ndarray, i: int):
        s = int(self.start[i])
        return images[s] if self.single else images[s:s + int(self.count[i])]

    def done(self, i: int, fut) -> None:
        """Done callback of request ``i``'s future (the session's thread)."""
        self.t_done[i] = time.perf_counter()
        answer = None
        if not fut.cancelled() and fut.exception() is None:
            answer = np.asarray(fut.result(), np.float32)
            answer = answer.reshape(-1, answer.shape[-1])
        with self._lock:
            if answer is not None:
                self._fold(int(self.start[i]), answer)
                self.ok[i] = True
            self._settled += 1
            if self._closed and self._settled == self.n:
                self._all.set()

    def fold(self, s: int, answer) -> None:
        """Fold in an answer for images ``s :`` of the pool to a request
        sent before the window, so that it is compared as well."""
        rows = np.asarray(answer, np.float32)
        with self._lock:
            self._fold(s, rows.reshape(-1, rows.shape[-1]))

    def _fold(self, s: int, rows: np.ndarray) -> None:
        if self.hi is None:
            self.lo = np.full((self.pool, rows.shape[1]), np.inf, np.float32)
            self.hi = np.full((self.pool, rows.shape[1]), -np.inf,
                              np.float32)
        k = len(rows)
        self.seen[s:s + k] = True
        np.minimum(self.lo[s:s + k], rows, out=self.lo[s:s + k])
        np.maximum(self.hi[s:s + k], rows, out=self.hi[s:s + k])

    def close(self, deadline: float) -> None:
        """The client has sent its last request: wait until every request
        sent is resolved, or until ``deadline`` (perf_counter seconds)."""
        with self._lock:
            self._closed = True
            if self._settled == self.n:
                self._all.set()
        self._all.wait(max(0.0, deadline - time.perf_counter()))


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, stream])


def _sizes(traffic: dict, n: int) -> np.ndarray:
    return np.full(n, int(traffic["images_per_request"]), np.int64)


def _starts(sizes: np.ndarray, pool: int, rng) -> np.ndarray:
    return rng.integers(0, pool - sizes + 1)


def schedule(traffic: dict, seconds: float, seed: int) -> np.ndarray:
    """Due times (seconds after the window opens) of an open loop:
    ``rate_per_s`` a second, the last at ``seconds``."""
    rate = float(traffic["rate_per_s"])
    n, rng = round(rate * seconds), _rng(seed, 1)
    if n <= 0:
        return np.empty(0)
    block = max(1, round(rate))
    gaps = []
    for at in range(0, n, block):
        k = min(block, n - at)
        q = (np.arange(k) + 0.5) / k
        gaps.append(rng.permutation(-np.log1p(-q) / rate))
    gaps = np.concatenate(gaps)
    return np.cumsum(gaps) * (seconds / gaps.sum())


def plan_open(traffic: dict, seconds: float, seed: int, pool: int) -> Window:
    due = schedule(traffic, seconds, seed)
    sizes = _sizes(traffic, len(due))
    return Window(_starts(sizes, pool, _rng(seed, 2)), sizes,
                  bool(traffic.get("single")), pool, due)


def plan_closed(traffic: dict, seconds: float, seed: int,
                pool: int) -> Window:
    """A closed loop's requests: a seeded cycle of ``CLOSED_CYCLE``, as
    many as the window can take."""
    sizes = _sizes(traffic, CLOSED_CYCLE)
    starts = _starts(sizes, pool, _rng(seed, 2))
    size = max(CLOSED_CYCLE, int(seconds * CLOSED_PER_S))
    return Window(np.resize(starts, size), np.resize(sizes, size),
                  bool(traffic.get("single")), pool)


class _Hooks:
    """Calls on the client thread once the window has run ``offset_s``."""

    def __init__(self, hooks, t0: float):
        self._todo = sorted(hooks, key=lambda h: h[0])
        self._t0 = t0

    def poll(self):
        while self._todo and \
                time.perf_counter() >= self._t0 + self._todo[0][0]:
            self._todo.pop(0)[1]()

    def flush(self):
        for _, fn in self._todo:
            fn()
        self._todo = []


def _submit(session, images, w: Window, i: int):
    w.t_submit[i] = time.perf_counter()
    fut = session.submit(w.payload(images, i))
    fut.add_done_callback(functools.partial(w.done, i))
    return fut


def _wait(fut, deadline: float) -> None:
    done = threading.Event()
    fut.add_done_callback(lambda _f: done.set())
    done.wait(max(0.0, deadline - time.perf_counter()))


def run_closed(session, images, w: Window, outstanding: int,
               seconds: float, hooks=()) -> Window:
    """A closed loop for ``seconds``; every request sent is waited for."""
    inflight = []
    w.t0 = time.perf_counter()
    end = w.t0 + seconds
    hk = _Hooks(hooks, w.t0)
    while time.perf_counter() < end:
        if len(inflight) >= outstanding:
            _wait(inflight.pop(0), end + LATE_S)
            hk.poll()
            continue
        if w.n == len(w.start):
            raise RuntimeError(f"the closed loop sent {w.n} requests, all "
                               f"its records hold")
        w.n += 1
        inflight.append(_submit(session, images, w, w.n - 1))
    hk.flush()
    w.close(end + LATE_S)
    return w


def run_open(session, images, w: Window, hooks=()) -> Window:
    """An open loop: each request sent at its due time, however late the
    session runs; every one is waited for."""
    w.t0 = time.perf_counter()
    hk = _Hooks(hooks, w.t0)
    for i in range(len(w.due)):
        hk.poll()
        delay = w.t0 + w.due[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        w.n = i + 1
        _submit(session, images, w, i)
    hk.flush()
    last = float(w.due[-1]) if len(w.due) else 0.0
    w.close(w.t0 + last + LATE_S)
    return w
