"""``repro_torch.spans`` — the port's span log: one process-wide, bounded,
preallocated in-memory record of what the serving session, the executor
and ``Accelerator.build`` did and when, kept like
``kernels.common.LAUNCHES``.

Each span is one record: a name from :data:`NAMES`, its start and end on
:func:`clock`, its own id, the id of the span that caused it (``-1`` for
none), the session it belongs to (``0`` outside a session; sessions count
from 1, :func:`new_session`) and one count where it has one (the rows or
the bucket; ``None`` otherwise). A request's span carries the request's
id (``_Request.rid``, counted per session, so an id is qualified by its
session) and names its batch as parent; a batch's spans all carry the
batch's id (counted per session too).

The names, and what each times:

* ``serving.await`` (dispatch thread): the session's queue was empty.
* ``serving.admit`` (dispatch thread): from the batch's first request taken
  to the cut; count: the rows.
* ``serving.hold`` (dispatch thread): the idle hold, the part of the
  admission during which the session's slot pool held no batch (the card
  had nothing of the session's to run).
* ``serving.slot`` (dispatch thread): ``_SlotPool.acquire``.
* ``serving.stage`` (dispatch thread, or a ``run_many`` caller): the batch
  assembled into its staging entry; count: the bucket.
* ``serving.launch`` (same): the host-to-card copy's enqueue, the graph's
  replay, the output's clone, the card-to-host copy's enqueue and the
  event's record; count: the bucket.
* ``serving.drain`` (drain thread): the wait for the batch's event.
* ``serving.deliver`` (drain thread): the host copy of the logits and the
  futures; count: the requests resolved.
* ``serving.device`` (drain thread, only while :func:`on`): an instant at
  the drain's end; count: the batch's card microseconds between two timed
  CUDA events, recorded before the copy in and after the copy out.
* ``serving.request``: from ``submit`` (the request's ``t_submit``) to its
  result; id: the request's; parent: its batch; count: its rows. Only
  requests answered with a result have one.
* ``executor.capture``: ``capture_graph`` in ``CompiledExecutor._capture``;
  id: the entry's ``id()``; count: the entry's batch.
* ``build``: ``Accelerator.build``; count: the batch. Its children (parent:
  the ``build`` span) ``build.dse``, ``build.calibrate`` (int8 only),
  ``build.compile``, ``build.load`` and ``build.validate``.

**The clock.** :func:`clock` is ``time.perf_counter``. On Linux it reads
``CLOCK_MONOTONIC``, as ``time.monotonic`` does, so a span and the
session's ``time.monotonic()`` stamps (``t_submit``, deadlines) share one
clock, and so do the benchmark harness's window times.

**The bound.** :data:`CAPACITY` is 2**18 = 262,144 spans, at about 0.2 KB
each when full. The busiest cell of the benchmark (single images at 1320
requests/s, about 171 batches/s) records over one 51 s window plus its
3.5 s traced segment about 72k request spans and 9.3k batches of at most
eight spans each, some 147k; the bulk cells (about 250 batches/s of one
request each) about 110k. Past the bound the oldest spans are overwritten.
A reader asks for the spans of an interval (:meth:`SpanLog.between`) and
gets ``None`` once the log no longer holds the interval's start, never a
part of it. The log is never cleared: it outlives every session and the
program cache.

**Cost.** Recording costs a clock read or two and one tuple stored per span,
with no lock. While a ``torch.profiler`` records, or inside
:func:`recording`, each span of the dispatch and drain threads but the
drain's wait is also a ``torch.profiler.record_function`` range on the
thread that does the work, and each session batch gets two timed CUDA
events; otherwise neither is made, and the check is a flag read.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import threading
import time

from torch.autograd import profiler as _profiler

AWAIT = "serving.await"
ADMIT = "serving.admit"
HOLD = "serving.hold"
SLOT = "serving.slot"
STAGE = "serving.stage"
LAUNCH = "serving.launch"
DRAIN = "serving.drain"
DELIVER = "serving.deliver"
DEVICE = "serving.device"
REQUEST = "serving.request"
CAPTURE = "executor.capture"
BUILD = "build"
BUILD_DSE = "build.dse"
BUILD_CALIBRATE = "build.calibrate"
BUILD_COMPILE = "build.compile"
BUILD_LOAD = "build.load"
BUILD_VALIDATE = "build.validate"
NAMES = (AWAIT, ADMIT, HOLD, SLOT, STAGE, LAUNCH, DRAIN, DELIVER, DEVICE,
         REQUEST, CAPTURE, BUILD, BUILD_DSE, BUILD_CALIBRATE, BUILD_COMPILE,
         BUILD_LOAD, BUILD_VALIDATE)

CAPACITY = 2 ** 18

clock = time.perf_counter

Span = collections.namedtuple(
    "Span", "name t0 t1 id parent session count")


class SpanLog:
    """A ring of ``capacity`` (a power of two) span records. Any thread may
    :meth:`record`, with no lock; readers take a snapshot.

    A record that overwrites another carries, as its last field, the
    latest end of every span its slot lost (the overwritten span's end, or
    what that span carried, whichever is later). So a snapshot knows, from
    its own records, that it holds every span that ended after the
    greatest of those marks."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity < 1 or capacity & (capacity - 1):
            raise ValueError(f"capacity {capacity} is not a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        self._ring: list = [None] * capacity
        self._seq = itertools.count()

    def record(self, name: str, t0: float, t1: float, sid: int = -1,
               parent: int = -1, session: int = 0, count=None) -> None:
        seq = next(self._seq)
        k = seq & self._mask
        old = self._ring[k]
        if old is None:
            lost = -math.inf
        else:
            lost = old[3] if old[3] > old[8] else old[8]
        self._ring[k] = (seq, name, t0, t1, sid, parent, session, count, lost)

    @staticmethod
    def _lost_until(ring: list) -> float:
        return max((r[8] for r in ring if r is not None), default=-math.inf)

    def between(self, t0: float | None = None, t1: float = math.inf
                ) -> list[Span] | None:
        """The spans that overlap ``[t0, t1]``, by start; every span held
        when ``t0`` is None. None when the log no longer holds ``t0``: a
        span that overlapped the interval may have been overwritten."""
        ring = list(self._ring)
        if t0 is not None and not self._lost_until(ring) < t0:
            return None
        lo = -math.inf if t0 is None else t0
        got = [r for r in ring if r is not None and r[3] >= lo
               and r[2] <= t1]
        got.sort(key=lambda r: (r[2], r[0]))
        return [Span._make(r[1:8]) for r in got]

    def holds(self, t: float) -> bool:
        """Every span that ended at or after ``t`` is still held."""
        return self._lost_until(list(self._ring)) < t


LOG = SpanLog()

_sessions = itertools.count(1)
_ids = itertools.count(1)


def new_session() -> int:
    """A new session's id in the log."""
    return next(_sessions)


def new_id() -> int:
    """A process-wide id for a span outside a session (a build)."""
    return next(_ids)


# -- profiler ranges ---------------------------------------------------------

_recording = 0
_recording_lock = threading.Lock()


def on() -> bool:
    """A ``torch.profiler`` records, or a :func:`recording` block is open:
    spans are also profiler ranges, and batches get timed events."""
    return _profiler._is_profiler_enabled or _recording > 0


@contextlib.contextmanager
def recording():
    """Inside this block every span is also a profiler range and every
    session batch gets its two timed CUDA events (``serving.device``),
    as while a ``torch.profiler`` records. Nests, and is process-wide."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def enter(name: str):
    """Open ``name`` as a profiler range on this thread while :func:`on`;
    returns what :func:`close` closes (None otherwise)."""
    if not (_profiler._is_profiler_enabled or _recording > 0):
        return None
    rng = _profiler.record_function(name)
    rng.__enter__()
    return rng


def close(rng, name: str, t0: float, sid: int = -1, parent: int = -1,
          session: int = 0, count=None) -> None:
    """End a span opened at ``t0`` (and its range ``rng``, from
    :func:`enter`) now, and record it in :data:`LOG`."""
    t1 = clock()
    if rng is not None:
        rng.__exit__(None, None, None)
    LOG.record(name, t0, t1, sid, parent, session, count)


@contextlib.contextmanager
def span(name: str, sid: int = -1, parent: int = -1, session: int = 0,
         count=None):
    """Record the block as a span (and a range while :func:`on`), also
    when it raises. For cold paths: the hot ones pair :func:`enter` with
    :func:`close`, which allocate nothing beyond the record."""
    t0, rng = clock(), enter(name)
    try:
        yield
    finally:
        close(rng, name, t0, sid, parent, session, count)
