"""Compiled-program cache: one lowered executor per full key.

The cache key is ``(program.schedule_key(), batch, dtype, param_dtypes,
backend, opt_level, donate_input, device, quant digest, mesh)``:

* ``schedule_key()`` is a content hash over the encoded 128-bit instruction
  stream plus the per-layer geometry, bit-equal to the reference package's
  key for the same specs and plans.
* ``batch``, ``dtype`` and the per-layer weight dtypes name the request
  shape the entry serves (dtype names as the reference spells them:
  ``"float32"``, ``"int8"``).
* ``backend`` ("torch" | "hopper") and ``opt_level`` change the lowering
  itself, and ``device`` where it runs, so each gets its own entry.
* ``donate_input``, in the reference's position: a donating entry's caller
  hands its input buffer over (a serving session's staging), and its CUDA
  graphs' static buffers are never shared with the direct ``acc(x)`` entry.
* the quant sidecar's ``digest()`` (``None`` for fp32): two calibrations of
  one Program never share an entry.
* ``executor.mesh_key(mesh)`` (``None`` unsharded), last so that the AOT
  artifact key's fields keep their places: a mesh of more than one
  position gets the sharded entry (``executor.ShardedExecutor``), and the
  batch must divide over its positions (``ValueError`` otherwise). A mesh
  of one position lowers as no mesh and shares the unsharded entry.

Every component is a content digest or a resolved scalar, so the key is the
same in every process; ``core/aot.py`` keys its artifacts by it.
``aot_dir`` names an AOT bundle: a miss loads the entry's exported program
from it when its artifact key matches (``stats.aot_loads``), and otherwise
lowers afresh with the reason logged.

Schedule validation runs **once per schedule key** (not per entry). Entries
are LRU-evicted beyond ``maxsize``; a schedule's validation stats go with
its last entry. The validation table itself is LRU-bounded at
``validated_maxsize`` (default ``4 * maxsize``) and never drops a schedule
that still has live entries, so validate-only callers cannot grow it
without limit.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import torch

from repro_torch.compat import resolve_backend
from repro_torch.core.compiler import Program
from repro_torch.core.executor import (
    CompiledExecutor,
    compile_executor,
    mesh_device_count,
    mesh_key,
    resolve_opt_level,
    validate_schedule,
)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    validated_evictions: int = 0    # validation-stat entries dropped
    aot_loads: int = 0              # misses served from a disk artifact


def dtype_name(dtype) -> str:
    """``torch.float32``, ``"float32"`` or a numpy dtype -> ``"float32"``."""
    return str(dtype).removeprefix("torch.")


def cache_key(program: Program, *, batch: int, dtype,
              param_dtypes: tuple = (), backend: str = "torch",
              opt_level: int = 1, donate_input: bool = False, device,
              mesh=None, quant=None) -> tuple:
    """The cache-key tuple for one executor request, in resolved form."""
    if mesh_device_count(mesh) == 1:
        mesh = None
    return (program.schedule_key(), int(batch), dtype_name(dtype),
            tuple(dtype_name(d) for d in param_dtypes),
            resolve_backend(backend), resolve_opt_level(opt_level),
            bool(donate_input), str(torch.device(device)),
            quant.digest() if quant is not None else None, mesh_key(mesh))


class ProgramCache:
    """LRU cache of :class:`CompiledExecutor` keyed by :func:`cache_key`."""

    def __init__(self, maxsize: int = 64,
                 validated_maxsize: int | None = None):
        self.maxsize = maxsize
        # one small counters dict per schedule; 4x the entry budget covers
        # every schedule with live entries plus validate-only callers
        self.validated_maxsize = (4 * maxsize if validated_maxsize is None
                                  else validated_maxsize)
        self.stats = CacheStats()
        self._entries: OrderedDict[tuple, CompiledExecutor] = OrderedDict()
        self._validated: OrderedDict[str, dict[str, int]] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def validated_size(self) -> int:
        """Schedules with cached validation stats (at most
        ``validated_maxsize`` plus those with live entries)."""
        return len(self._validated)

    def validate(self, program: Program) -> dict[str, int]:
        """Hazard-check ``program`` once per schedule key; return counters."""
        key = program.schedule_key()
        with self._lock:
            stats = self._validated.get(key)
            if stats is not None:
                self._validated.move_to_end(key)
        if stats is None:
            stats = validate_schedule(program)   # raises HazardError
            with self._lock:
                self._validated[key] = stats
                self._validated.move_to_end(key)
                self._evict_validated_locked()
        return dict(stats)

    def _evict_validated_locked(self):
        """LRU-bound the validation table; never drop a schedule that still
        has live entries."""
        if len(self._validated) <= self.validated_maxsize:
            return
        live = {k[0] for k in self._entries}
        for skey in list(self._validated):
            if len(self._validated) <= self.validated_maxsize:
                break
            if skey in live:
                continue
            del self._validated[skey]
            self.stats.validated_evictions += 1

    def get(self, program: Program, *, batch: int, dtype,
            param_dtypes: tuple = (), backend: str = "torch",
            opt_level: int = 1, donate_input: bool = False, device,
            mesh=None, quant=None,
            aot_dir: str | None = None) -> CompiledExecutor:
        """The executor for ``program`` at this batch/dtype/backend/
        opt_level/donation/device/mesh/quant sidecar (lowered on a miss, or
        loaded from the AOT bundle ``aot_dir`` when it holds this key; a
        sharded entry is never loaded from disk)."""
        if mesh_device_count(mesh) == 1:
            mesh = None
        n = mesh_device_count(mesh)
        if batch % n:
            raise ValueError(
                f"sharded executor: batch {batch} does not divide evenly "
                f"over the mesh's {n} positions; pad the batch to a "
                f"multiple (the serving session's bucket fallback) or drop "
                f"the mesh for this batch size")
        key = cache_key(program, batch=batch, dtype=dtype,
                        param_dtypes=param_dtypes, backend=backend,
                        opt_level=opt_level, donate_input=donate_input,
                        device=device, mesh=mesh, quant=quant)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return entry
        stats = self.validate(program)
        entry = None
        if aot_dir is not None and mesh is None:
            from repro_torch.core import aot
            fn = aot.load_entry(aot_dir, key)
            if fn is not None:
                entry = CompiledExecutor(
                    program=program, stats=dict(stats), fn=fn,
                    build_count=0, backend=key[4], opt_level=key[5],
                    donate_input=key[6], aot_loaded=True, device=key[7])
                with self._lock:
                    self.stats.aot_loads += 1
        if entry is None:
            entry = compile_executor(program, stats=stats, backend=key[4],
                                     opt_level=key[5], donate_input=key[6],
                                     device=key[7], quant=quant, mesh=mesh)
        with self._lock:
            # a racing thread may have built the same key meanwhile: first
            # insert wins so every caller holds the same executor
            existing = self._entries.get(key)
            if existing is not None:
                self.stats.hits += 1
                return existing
            self._entries[key] = entry
            self.stats.misses += 1
            while len(self._entries) > self.maxsize:
                old_key, _ = self._entries.popitem(last=False)
                self.stats.evictions += 1
                # a schedule's validation stats go with its last entry
                skey = old_key[0]
                if (skey in self._validated
                        and not any(k[0] == skey for k in self._entries)):
                    del self._validated[skey]
                    self.stats.validated_evictions += 1
        return entry

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._validated.clear()
            self.stats = CacheStats()


_default = ProgramCache()


def default_cache() -> ProgramCache:
    """The process-wide cache used by ``HybridRuntime`` unless one is passed."""
    return _default
