"""Watchdog building blocks for the supervised serving pipeline.

``api.ServingSession`` runs one supervisor thread per session; the pieces
it schedules with live here so they are testable without a device in the
loop:

* :class:`DeadlineTable` — a thread-safe min-heap of request deadlines.
  The supervisor sleeps until the earliest deadline (or its poll tick),
  then fails every due request with ``DeadlineExceeded``. Entries for
  requests that already resolved are dropped lazily when they come due.
* :class:`ThreadSupervisor` — liveness tracking for the dispatch/drain
  threads, adapting ``repro_torch.checkpoint.HeartbeatMonitor`` (the
  training fleet's straggler/dead-worker detector) to pipeline threads:
  each thread ``beat()``s once per loop iteration, and a thread that
  stays silent for ``hang_after_s`` *while the session has work* is
  reported hung. Idle silence is not a hang — ``update_busy`` re-arms
  every heartbeat on the idle->busy edge so a long-quiet session never
  false-positives the moment traffic returns.

Dead-*thread* detection (``Thread.is_alive()`` going false) needs no
heartbeats and is handled directly by the session's supervisor; this
module covers the time-based half of the failure model.
"""
from __future__ import annotations

import heapq
import itertools
import threading

from repro_torch.checkpoint import HeartbeatMonitor


class DeadlineTable:
    """Min-heap of ``(deadline_monotonic, item)`` with thread-safe ops."""

    def __init__(self):
        self._heap: list = []
        self._lock = threading.Lock()
        self._seq = itertools.count()   # tie-break: never compare items

    def add(self, t: float, item) -> bool:
        """Push; True when ``t`` became the new earliest deadline (the
        supervisor must be woken to shorten its sleep)."""
        with self._lock:
            was_min = self._heap[0][0] if self._heap else None
            heapq.heappush(self._heap, (float(t), next(self._seq), item))
            return was_min is None or t < was_min

    def pop_due(self, now: float) -> list:
        """Pop and return every item whose deadline is <= ``now``."""
        due = []
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                due.append(heapq.heappop(self._heap)[2])
        return due

    def next_at(self) -> float | None:
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


class ThreadSupervisor:
    """Hang detection for a fixed set of named pipeline threads.

    Wraps :class:`repro_torch.checkpoint.HeartbeatMonitor`: thread ``name``
    maps to monitor worker index, ``beat`` -> ``report``, and ``hung()`` ->
    ``monitor.dead()`` gated on the session being busy. ``hang_after_s
    = None`` disables time-based detection entirely (``hung()`` is always
    empty) while ``beat`` stays cheap enough to call unconditionally."""

    def __init__(self, names, hang_after_s: float | None = None):
        self.names = tuple(names)
        self._idx = {n: i for i, n in enumerate(self.names)}
        self.hang_after_s = hang_after_s
        self._monitor = HeartbeatMonitor(
            len(self.names),
            dead_after_s=hang_after_s if hang_after_s else 60.0)
        self._busy = False
        self._lock = threading.Lock()

    def beat(self, name: str, step_time: float = 0.0,
             now: float | None = None):
        with self._lock:
            self._monitor.report(self._idx[name], step_time, now=now)

    def update_busy(self, busy: bool, now: float | None = None):
        """Track whether the session has work. On the idle->busy edge every
        heartbeat re-arms: stale idle-era timestamps must not count as
        silence against the hang window."""
        with self._lock:
            if busy and not self._busy:
                for i in range(len(self.names)):
                    self._monitor.report(i, 0.0, now=now)
            self._busy = busy

    def hung(self, now: float | None = None) -> list[str]:
        """Thread names silent past ``hang_after_s`` while busy."""
        if self.hang_after_s is None:
            return []
        with self._lock:
            if not self._busy:
                return []
            return [self.names[i] for i in self._monitor.dead(now=now)]

    def stragglers(self) -> list[str]:
        """Relatively-slow threads (z-score over the set median) — exposed
        for observability, never a restart trigger."""
        with self._lock:
            return [self.names[i] for i in self._monitor.stragglers()]
