"""``repro_torch.serving`` — the serving layer's failure model.

Typed request failures (:class:`DeadlineExceeded`, :class:`Overloaded`,
:class:`NumericsError`, :class:`PipelineCrashed`), the deterministic
fault-injection harness (:class:`FaultPlan` / :class:`FaultSpec` /
:func:`chaos_soak`) and the watchdog building blocks
(:class:`DeadlineTable`, :class:`ThreadSupervisor`) used by
``api.ServingSession``. See the "Failure model" section of
``docs/ARCHITECTURE.md``.
"""
from repro_torch.serving.errors import (
    DeadlineExceeded,
    InjectedFault,
    NumericsError,
    Overloaded,
    PipelineCrashed,
    ServingError,
    ThreadKilled,
)
from repro_torch.serving.faults import (
    KINDS,
    SITES,
    FaultPlan,
    FaultSpec,
    chaos_soak,
)
from repro_torch.serving.watchdog import DeadlineTable, ThreadSupervisor

__all__ = [
    "DeadlineExceeded", "DeadlineTable", "FaultPlan", "FaultSpec",
    "InjectedFault", "KINDS", "NumericsError", "Overloaded",
    "PipelineCrashed", "SITES", "ServingError", "ThreadKilled",
    "ThreadSupervisor", "chaos_soak",
]
