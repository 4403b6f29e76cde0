"""AOT executor artifacts: ship the exported executor, not the recipe.

``Accelerator.save_program(..., aot=True)`` exports each warmed executor
entry with ``torch.export`` into a bundle directory next to the
instruction image; ``ProgramCache.get(..., aot_dir=...)`` loads it back on
a cache miss, skipping the lowering. This is the port's counterpart of
``src/repro/core/aot.py``, which serializes XLA executables.

The artifact
------------
``torch.export`` of the lowered ``execute(params, x)`` at the entry's
shapes, traced with fake tensors (no device math at save time), saved with
``torch.export.save``. The params are inputs of the exported program, so
the weights are not stored: the instruction image and the params stay in
their own files. The CNN kernels appear in it as their
``torch.ops.repro_torch`` ops (``kernels/common.py``), whose CUDA
implementation is the kernel's launch; a loaded entry is captured into a
CUDA graph on first use like any other (``executor.CompiledExecutor``).

Keying
------
Artifacts are keyed by the FULL program-cache key (schedule digest, batch,
dtype, per-layer param dtypes, backend, opt_level, input donation, device,
quant-sidecar digest) PLUS the environment fingerprint (the device's name,
the platform, the torch and CUDA versions and the kernel library's source
digest). The whole key dict is hashed into the artifact's filename and
stored verbatim in a ``manifest.json`` side index.

Fallback semantics
------------------
A lookup that misses NEVER errors and NEVER serves a stale artifact: the
caller lowers afresh (bit-exact by construction, the artifact being an
export of the very same lowered function), and the *reason* (which key
dimension went stale, saved vs wanted) is logged on the ``repro_torch.aot``
logger. A manifest entry that no longer matches its own digest and an
unreadable or truncated artifact fall back the same way. A bundle written
by the reference package (format ``hybriddnn-aot/v1``) reads as stale on
``format`` and the environment dimensions; its ``program.json`` loads as
it is.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import platform as _platform

import torch

log = logging.getLogger("repro_torch.aot")

AOT_FORMAT = "hybriddnn-aot-torch/v1"
MANIFEST = "manifest.json"

# The serving fault harness (repro_torch.serving.faults) installs a hook
# here to exercise the warn-and-rebuild path deterministically. The hook
# runs INSIDE load_entry's artifact try-block, so anything it raises is
# indistinguishable from a corrupt artifact on disk.
_fault_hook = None


def set_fault_hook(hook):
    """Install ``hook(digest)`` to run on every artifact read attempt;
    returns the previous hook so callers can restore it."""
    global _fault_hook
    prev, _fault_hook = _fault_hook, hook
    return prev


# the stale-diagnosis report walks these in order, so the most identity-like
# dimensions (schedule, environment) lead the logged reason
KEY_DIMENSIONS = (
    "format", "schedule", "batch", "dtype", "param_dtypes", "backend",
    "opt_level", "donate_input", "device", "quant_digest",
    "device_name", "platform", "torch_version", "cuda_version",
    "kernel_digest",
)


class AOTError(ValueError):
    """A malformed AOT bundle operation (bad save inputs, unwritable dir)."""


def environment_fingerprint(device="cpu") -> dict:
    """The environment dimensions of the artifact key for an entry on
    ``device``: the device's name (``cpu`` on the CPU) and the platform,
    because the artifact holds device-specific tensors and ops; the torch
    and CUDA versions, because the export format and the ops' behaviour
    drift across releases; the kernel library's source digest, because the
    ops launch those kernels. Computed fresh each call, so tests can
    monkeypatch it."""
    from repro_torch.kernels.common import source_digest
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {
        "device_name": name,
        "platform": f"{_platform.system()}-{_platform.machine()}",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "kernel_digest": source_digest(),
    }


def artifact_key(cache_key: tuple, env: dict | None = None) -> dict:
    """The full artifact key dict for one program-cache key tuple
    (:func:`repro_torch.core.program_cache.cache_key`), the environment
    fingerprint joined. JSON-normalized (tuples become lists) so it digests
    and round-trips through the manifest identically."""
    (schedule, batch, dtype, param_dtypes, backend, opt_level, donate_input,
     device, quant_digest, *mesh) = cache_key
    if any(m is not None for m in mesh):
        raise ValueError("a sharded entry has no AOT artifact: it is "
                         "lowered in the serving process")
    key = {
        "format": AOT_FORMAT,
        "schedule": schedule,
        "batch": int(batch),
        "dtype": str(dtype),
        "param_dtypes": list(param_dtypes),
        "backend": backend,
        "opt_level": int(opt_level),
        "donate_input": bool(donate_input),
        "device": str(device),
        "quant_digest": quant_digest,
    }
    key.update(environment_fingerprint(device) if env is None else dict(env))
    return json.loads(json.dumps(key))


def artifact_digest(key: dict) -> str:
    """Content digest of an artifact key: the artifact's filename stem."""
    return hashlib.sha256(
        json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]


def _artifact_path(aot_dir: str, digest: str) -> str:
    return os.path.join(aot_dir, f"{digest}.pt2")


def read_manifest(aot_dir: str) -> dict:
    """digest -> key dict for every artifact in ``aot_dir`` ({} if none)."""
    path = os.path.join(aot_dir, MANIFEST)
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, json.JSONDecodeError) as e:
        log.warning("aot: manifest %s unreadable (%s) — treating the "
                    "bundle as empty", path, e)
        return {}
    return doc if isinstance(doc, dict) else {}


def _write_manifest(aot_dir: str, manifest: dict):
    # tmp + rename: a crashed save must not leave a half-written index that
    # poisons every later load
    path = os.path.join(aot_dir, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _diff_dims(saved: dict, wanted: dict) -> list[tuple[str, object, object]]:
    """(dimension, saved, wanted) for every key dimension that differs."""
    dims = [d for d in KEY_DIMENSIONS if d in saved or d in wanted]
    for extra in sorted(set(saved) | set(wanted)):
        if extra not in dims:
            dims.append(extra)
    return [(d, saved.get(d), wanted.get(d)) for d in dims
            if saved.get(d) != wanted.get(d)]


def _fmt_diffs(diffs: list[tuple[str, object, object]]) -> str:
    return "; ".join(f"{d}: saved={s!r} wanted={w!r}" for d, s, w in diffs)


def _register_ops() -> None:
    """Import the kernel modules, which register the ``repro_torch`` ops an
    exported program calls."""
    import repro_torch.kernels.gemm.int8  # noqa: F401
    import repro_torch.kernels.gemm.kernel  # noqa: F401
    import repro_torch.kernels.spatial_conv.kernel  # noqa: F401
    import repro_torch.kernels.winograd.kernel  # noqa: F401


class _Executor(torch.nn.Module):
    """``torch.export`` takes a module: this one calls the lowered fn."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, params, x):
        return self.fn(params, x)


def save_entry(aot_dir: str, executor, params, x_shape, dtype,
               cache_key: tuple, env: dict | None = None) -> str:
    """Export ``executor.fn`` at these shapes and persist it; returns the
    artifact digest.

    ``executor`` is a :class:`repro_torch.core.executor.CompiledExecutor`
    built by lowering (a loaded one holds no Python function to trace);
    ``params`` only contributes shapes and dtypes (the export traces fake
    tensors, and the weights are not stored)."""
    if getattr(executor, "aot_loaded", False):
        raise AOTError("an AOT-loaded entry cannot be exported again: "
                       "export a freshly lowered entry")
    _register_ops()
    key = artifact_key(cache_key, env)
    digest = artifact_digest(key)
    os.makedirs(aot_dir, exist_ok=True)
    device = torch.device(key["device"])
    params = [tuple(p) for p in params]
    x = torch.empty(tuple(x_shape), dtype=getattr(torch, key["dtype"]),
                    device=device)
    with torch.no_grad():
        ep = torch.export.export(_Executor(executor.fn), (params, x),
                                strict=False)
    # the example inputs are the params and x: saved with the program,
    # they would store the weights in every artifact
    ep.example_inputs = None
    path = _artifact_path(aot_dir, digest)
    tmp = _artifact_path(aot_dir, f"{digest}.tmp")
    torch.export.save(ep, tmp)
    os.replace(tmp, path)
    manifest = read_manifest(aot_dir)
    manifest[digest] = key
    _write_manifest(aot_dir, manifest)
    log.info("aot: saved %s (%d KiB, batch=%s dtype=%s backend=%s "
             "opt_level=%s)", digest, os.path.getsize(path) // 1024,
             key["batch"], key["dtype"], key["backend"], key["opt_level"])
    return digest


def load_entry(aot_dir: str, cache_key: tuple, env: dict | None = None):
    """The loaded executor function for this key, or ``None`` with the
    stale reason logged: the caller then lowers afresh, which is bit-exact
    by construction."""
    wanted = artifact_key(cache_key, env)
    digest = artifact_digest(wanted)
    manifest = read_manifest(aot_dir)
    path = _artifact_path(aot_dir, digest)
    saved = manifest.get(digest)
    if saved is not None and os.path.exists(path):
        stale = _diff_dims(saved, wanted)
        if stale:
            # hand-edited manifest: its entry no longer matches the digest
            log.warning(
                "aot: artifact %s manifest entry does not match its own "
                "digest (%s) — falling back to a fresh build", digest,
                _fmt_diffs(stale))
            return None
        try:
            if _fault_hook is not None:
                _fault_hook(digest)
            _register_ops()
            fn = torch.export.load(path).module()
        except Exception as e:  # noqa: BLE001 — any bad artifact rebuilds
            log.warning("aot: artifact %s unreadable (%s: %s) — falling "
                        "back to a fresh build", digest,
                        type(e).__name__, e)
            return None
        log.info("aot: loaded %s (batch=%s dtype=%s backend=%s "
                 "opt_level=%s)", digest, wanted["batch"], wanted["dtype"],
                 wanted["backend"], wanted["opt_level"])
        return fn
    if not manifest:
        log.info("aot: %s holds no artifacts — fresh build", aot_dir)
        return None
    # diagnose WHICH dimension went stale: report the nearest saved key
    best_digest, best_diffs = None, None
    for d, key in manifest.items():
        diffs = _diff_dims(key if isinstance(key, dict) else {}, wanted)
        if best_diffs is None or len(diffs) < len(best_diffs):
            best_digest, best_diffs = d, diffs
    log.warning(
        "aot: no artifact for key %s — nearest saved artifact %s is stale "
        "on [%s]; falling back to a fresh build", digest, best_digest,
        _fmt_diffs(best_diffs or []))
    return None
