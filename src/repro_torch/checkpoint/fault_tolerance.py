"""Fault tolerance: heartbeat/straggler monitoring.

``HeartbeatMonitor`` keeps per-worker step-completion timestamps; a worker
is a straggler when its step time exceeds ``zscore_threshold`` sigma over
the fleet median (rolling window), dead when silent for ``dead_after_s``.
The serving watchdog maps its pipeline threads onto the monitor's workers.
The logic and names are the reference package's.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class WorkerState:
    last_seen: float
    step_times: list[float] = dataclasses.field(default_factory=list)


class HeartbeatMonitor:
    def __init__(self, n_workers: int, window: int = 16,
                 zscore_threshold: float = 3.0, dead_after_s: float = 60.0):
        now = time.monotonic()
        self.workers = {i: WorkerState(now) for i in range(n_workers)}
        self.window = window
        self.z = zscore_threshold
        self.dead_after = dead_after_s

    def report(self, worker: int, step_time: float,
               now: float | None = None):
        w = self.workers[worker]
        w.last_seen = now if now is not None else time.monotonic()
        w.step_times.append(step_time)
        if len(w.step_times) > self.window:
            w.step_times.pop(0)

    def stragglers(self) -> list[int]:
        """Workers whose median step time z-scores above the fleet."""
        meds = {i: np.median(w.step_times)
                for i, w in self.workers.items() if w.step_times}
        if len(meds) < 2:
            return []
        vals = np.array(list(meds.values()))
        fleet_med = np.median(vals)
        mad = np.median(np.abs(vals - fleet_med)) + 1e-9
        return [i for i, m in meds.items()
                if (m - fleet_med) / (1.4826 * mad) > self.z]

    def dead(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return [i for i, w in self.workers.items()
                if now - w.last_seen > self.dead_after]
