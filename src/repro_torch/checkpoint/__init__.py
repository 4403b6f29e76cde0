"""``repro_torch.checkpoint`` — checkpoints and fault tolerance.

``checkpoint`` writes and restores the reference package's checkpoint
format (``step_<N>/arrays.npz``, ``manifest.json``, an atomic ``LATEST``),
so either package restores the other's. ``run_with_recovery`` restarts a
step function from the latest checkpoint and ``elastic_restore`` restores
one onto another placement. ``HeartbeatMonitor`` (straggler z-score +
dead-after-silence detection) is re-exported here because the serving
watchdog (``repro_torch.serving.watchdog.ThreadSupervisor``) adapts it as
its pipeline hang detector.
"""
from repro_torch.checkpoint.fault_tolerance import (
    HeartbeatMonitor,
    WorkerState,
    elastic_restore,
    run_with_recovery,
)

__all__ = ["HeartbeatMonitor", "WorkerState", "elastic_restore",
           "run_with_recovery"]
