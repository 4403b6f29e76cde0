"""``repro_torch.checkpoint`` — the fault-tolerance seeds the serving
watchdog uses.

Only ``HeartbeatMonitor`` (straggler z-score + dead-after-silence
detection) and its ``WorkerState`` are ported so far: the serving watchdog
(``repro_torch.serving.watchdog.ThreadSupervisor``) adapts the monitor as
its pipeline hang detector. Sharded checkpoints, ``run_with_recovery`` and
``elastic_restore`` are not ported (ROADMAP Queue 1, item 11f).
"""
from repro_torch.checkpoint.fault_tolerance import (
    HeartbeatMonitor,
    WorkerState,
)

__all__ = ["HeartbeatMonitor", "WorkerState"]
