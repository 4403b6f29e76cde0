"""Typed failures for the serving layer.

Every way a ``ServingSession`` request can fail resolves its ``Future``
with one of these (or the causal exception of a batch failure) — a caller
that catches ``ServingError`` has seen every session-originated failure.
``ThreadKilled`` is the one deliberate exception to that rule: it models a
pipeline thread dying mid-loop (the fault harness's ``kind="kill"``), so it
derives from ``BaseException`` to escape the per-batch ``except Exception``
recovery handlers the way a real ``SystemExit``/segfaulting-extension crash
would — only the thread's outermost wrapper sees it.
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for every session-originated request failure."""


class DeadlineExceeded(ServingError, TimeoutError):
    """The request's ``deadline_ms`` elapsed before its result drained.

    Also a ``TimeoutError`` so generic timeout handling catches it."""


class Overloaded(ServingError):
    """Admission refused: the pending queue is at ``queue_limit`` and the
    session sheds instead of blocking (``on_overload="shed"``)."""


class NumericsError(ServingError, ArithmeticError):
    """``guard_numerics=True`` quarantined this request: its output rows
    contain NaN/Inf. Co-batched finite requests resolve normally."""


class PipelineCrashed(ServingError):
    """A dispatch/drain thread died (or hung past ``hang_after_s``); the
    watchdog failed this queued/in-flight request and restarted the
    pipeline. Carries the causal exception as ``__cause__`` when known."""


class InjectedFault(ServingError):
    """Raised by a :class:`repro_torch.serving.FaultPlan` ``kind="error"``
    spec — a deterministic stand-in for device/runtime failures."""


class ThreadKilled(BaseException):
    """Fault-harness ``kind="kill"``: simulates a pipeline thread dying
    without cleanup. Derives from ``BaseException`` so the per-batch
    recovery handlers (``except Exception``) cannot absorb it."""
