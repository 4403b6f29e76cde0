"""Fault tolerance: heartbeat/straggler monitoring, restart-from-latest,
elastic re-meshing. The logic and names are the reference package's.

* ``HeartbeatMonitor`` — per-worker step-completion timestamps; a worker is
  a straggler when its step time exceeds ``zscore_threshold`` sigma over
  the fleet median (rolling window), dead when silent for ``dead_after_s``.
  The serving watchdog maps its pipeline threads onto the monitor's
  workers.
* ``run_with_recovery`` — drives a step function; on failure restores the
  latest checkpoint and replays from its step (a deterministic step
  function, e.g. over ``data.pipeline``, makes the recovery bit-exact).
* ``elastic_restore`` — restores a checkpoint onto another placement: the
  caller's ``param_sharding_fn`` (e.g. ``parallel.sharding.param_shardings``)
  says where each leaf goes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.parallel.sharding import Placed


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


def _placements(tree):
    """Each leaf's device, or a placed leaf's placement (``None`` for a
    leaf that is no tensor)."""
    def where(t):
        if isinstance(t, Placed):
            return t.sharding
        return t.device if isinstance(t, torch.Tensor) else None
    return pytree.tree_map(where, tree,
                           is_leaf=lambda x: isinstance(x, Placed))


def run_with_recovery(
    step_fn: Callable,        # (state, step) -> state ; may raise
    init_state,
    n_steps: int,
    ckpt_dir: str,
    *,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    on_restore: Callable | None = None,
):
    """A step loop with checkpoint/restart. Returns (state, log).

    ``step_fn`` may raise (a simulated node failure); the loop restores
    the latest checkpoint, each tensor leaf onto the device it was on, and
    resumes from its step. The log records every restart."""
    state = init_state
    log = {"restarts": 0, "completed": []}
    step = 0
    restarts = 0
    ckpt_lib.save(ckpt_dir, 0, state)
    while step < n_steps:
        try:
            state = step_fn(state, step)
            log["completed"].append(step)
            step += 1
            if step % ckpt_every == 0:
                ckpt_lib.save(ckpt_dir, step, state)
        except Exception:
            restarts += 1
            log["restarts"] = restarts
            if restarts > max_restarts:
                raise
            state, restored_step = ckpt_lib.restore(
                ckpt_dir, state, shardings=_placements(state))
            if on_restore is not None:
                state = on_restore(state)
            step = restored_step
    ckpt_lib.save(ckpt_dir, n_steps, state)
    return state, log


def elastic_restore(ckpt_dir: str, template, new_rules, param_sharding_fn,
                    *, device=None):
    """Restore the latest checkpoint onto another placement.

    ``param_sharding_fn(template, new_rules)`` -> a placements tree (a
    ``torch.device`` or ``NamedSharding`` per leaf, ``None`` for
    ``device``), e.g. ``parallel.sharding.param_shardings``; with no
    ``new_rules`` every leaf goes to ``device``."""
    shardings = param_sharding_fn(template, new_rules) if new_rules else None
    return ckpt_lib.restore(ckpt_dir, template, shardings=shardings,
                            device=device)
