"""``repro_torch.api`` — the user surface of the PyTorch port (Fig. 1 flow).

    from repro_torch import api
    from repro_torch.core import perf_model as pm
    from repro_torch.models import vgg

    specs = vgg.network_specs(224, 1, n_classes=1000)
    acc = api.Accelerator.build(specs, pm.V5E, batch=8, backend="hopper")
    logits = acc(x)                 # cached, validated executor on the card
    print(acc.summary())            # per-layer mode/dataflow/latency table

``Accelerator.build`` runs the DSE through the ``Target`` protocol
(``pm.V5E``, ``pm.VU9P``, ``pm.PYNQ_Z1`` — the reference's planning models,
so both packages plan the same layers), compiles ONE ``Program``, validates
its hazard schedule once, loads the DRAM weight image on the device and
returns a callable accelerator.

``backend="torch"`` runs every CONV/FC block through aten ops;
``backend="hopper"`` through the hand-written CUDA kernels. ``device=None``
means the CUDA card and raises when there is none; pass ``device="cpu"`` to
run on the CPU (where ``"hopper"`` runs each kernel's plain version).
``dtype="int8"`` builds a quantized accelerator (calibration, a
``QuantSidecar``, int8 PEs through K5 on ``"hopper"``) that stays
float-in/float-out. ``strict=True`` answers through the per-instruction
interpreter instead of the cached executor, and ``strict_request()`` gives
any accelerator an interpreted request on the ``torch`` PE, the oracle the
executor is held to. ``segmented=True`` builds the legacy multi-Program
path (one Program per CONV segment, a host maxpool between segments, the
FC tail through ``hybrid_conv.dense``).

``Accelerator.save_program`` / ``Accelerator.from_program`` persist the
compiled instruction stream (plus specs, plans, the DSE verdict and the
int8 sidecar) as the reference's ``hybriddnn-program/v1`` document, so a
program saved by either package loads in the other; the loader recompiles
and verifies the stream bit for bit.

``Accelerator.serve()`` opens a :class:`ServingSession`: a
continuous-batching request queue that coalesces requests into device
batches padded up to a fixed set of bucket sizes (one cached executor per
bucket), stages them in pinned host buffers, keeps up to three batches in
flight on one CUDA stream, and carries the reference's failure model
(deadlines, bounded admission, poisoned-batch bisection, NaN quarantine,
a supervising watchdog). ``Fleet`` serves several models over one shared
slot pool.

``save_program(path, aot=True)`` writes an AOT bundle: ``program.json``
plus ``aot/``, one ``torch.export`` artifact per serving bucket and the
direct entry (``core/aot.py``); ``from_program(bundle)`` loads each entry
from it when its key and environment match, and builds afresh otherwise.
On a card every executor entry runs as CUDA graphs (``core/executor.py``).

``serve(mesh=...)`` and ``Fleet(mesh=...)`` shard every bucket the mesh
divides over its positions (``launch/mesh.py``; a mesh may repeat a
device, each position one replica): the batch split on dim 0, the weights
replicated once, each shard an ordinary single-device entry, the logits
gathered on the mesh's first device. The reference's ``pallas`` -> ``xla``
degradation is deliberately not ported: a failed ``hopper`` batch is never
re-run on the aten lowering (ROADMAP).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import logging
import math
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.compat import (
    Mesh,
    make_mesh,
    resolve_backend,
    resolve_device,
    to_numpy,
    to_tensor,
)
from repro_torch import spans
from repro_torch.core import perf_model as pm
from repro_torch.core.compiler import (
    NO_PLAN,
    LayerPlan,
    Program,
    compile_network,
)
from repro_torch.core.dse import DSEResult, FPGACandidate, TPUCandidate
from repro_torch.core.executor import mesh_device_count, resolve_opt_level
from repro_torch.core.hybrid_conv import (
    ConvSpec,
    DepthwiseSpec,
    EltwiseSpec,
    FCSpec,
    PoolSpec,
    dense,
    max_pool2d,
)
from repro_torch.core.runtime import HybridRuntime
from repro_torch.quant import QuantSidecar, calibrate, quantize_params
from repro_torch.serving import (
    DeadlineExceeded,
    DeadlineTable,
    NumericsError,
    Overloaded,
    PipelineCrashed,
    ThreadSupervisor,
)

PROGRAM_FORMAT = "hybriddnn-program/v1"

log = logging.getLogger("repro_torch.serving")


class ProgramLoadError(ValueError):
    """A saved program that cannot be loaded: truncated or non-JSON file,
    unknown format version, instruction-stream or quant-sidecar digest
    mismatch, or a directory without ``program.json``. Subclasses
    ``ValueError`` so callers that catch the broad class keep working."""


@runtime_checkable
class Target(Protocol):
    """Anything that can run the paper's DSE for a layer chain."""

    def run_dse(self, specs, batch: int = 1) -> DSEResult: ...


def _random_arrays(specs: Sequence[Any], seed: int) -> list:
    """The reference's ``api.random_params`` draws, as float32 numpy arrays
    (numpy ``default_rng(seed)``, fan-in scaled in float32)."""
    rng = np.random.default_rng(seed)
    params = []
    for s in specs:
        if isinstance(s, ConvSpec):
            shape, fan_in, n_out = (s.r, s.s, s.c, s.k), s.r * s.s * s.c, s.k
        elif isinstance(s, DepthwiseSpec):
            shape, fan_in, n_out = (s.r, s.s, 1, s.c), s.r * s.s, s.c
        elif isinstance(s, FCSpec):
            shape, fan_in, n_out = (s.d_in, s.d_out), s.d_in, s.d_out
        else:
            continue
        w = (rng.standard_normal(shape).astype(np.float32)
             * np.float32(fan_in ** -0.5))
        params.append((w, np.zeros((n_out,), np.float32)))
    return params


def params_from_numpy(params: Sequence, device) -> list:
    """The reference's ``[(w, b), ...]`` as numpy arrays (HWIO conv and
    ``(d_in, d_out)`` FC weights) -> tensors on ``device``: floats become
    float32, and a quantized image (int8 weights, int32 biases) keeps its
    types."""
    return [tuple(to_tensor(a, torch.device(device)) for a in p)
            for p in params]


def random_params(specs: Sequence[Any], seed: int = 0, device=None) -> list:
    """Random ``[(w, b), ...]`` for every parameterized layer, bit for bit
    the reference's ``api.random_params(specs, seed)``, on ``device``
    (``None`` = the CUDA card)."""
    return params_from_numpy(_random_arrays(specs, seed),
                             resolve_device(device))




def _conv_segments_of(specs) -> list[int]:
    """Consecutive-CONV run lengths between maxpools (VGG16: [2,2,3,3,3]).

    The segmented request glues segments with a host-side maxpool, so the
    chain must be ``(CONV+ POOL)+ FC*`` — anything else (trailing CONVs
    without a pool, a pool before any CONV, CONVs after the FC tail) gets a
    descriptive error instead of an opaque crash downstream."""
    segments, run, seen_fc = [], 0, False
    for s in specs:
        if isinstance(s, (EltwiseSpec, DepthwiseSpec)):
            raise ValueError(
                f"segmented path: {type(s).__name__} {s.name!r} — residual "
                f"adds and depthwise convs need the single-Program path "
                f"(segmented=False); the legacy glue only handles "
                f"(CONV+ POOL)+ FC*")
        if isinstance(s, ConvSpec):
            if s.inp_from is not None:
                raise ValueError(
                    f"segmented path: CONV {s.name!r} reroutes its input "
                    f"(inp_from={s.inp_from}) — skip wiring needs the "
                    f"single-Program path (segmented=False)")
            if seen_fc:
                raise ValueError("segmented path: CONV after the FC tail")
            run += 1
        elif isinstance(s, PoolSpec):
            if seen_fc:
                raise ValueError("segmented path: POOL after the FC tail")
            if run == 0:
                raise ValueError(
                    "segmented path: maxpool without a preceding CONV "
                    "segment — the chain must be (CONV+ POOL)+ FC*")
            segments.append(run)
            run = 0
        else:
            seen_fc = True
    if run:
        raise ValueError(
            "segmented path: trailing CONV segment without a maxpool — "
            "use the single-Program path (segmented=False) for this chain")
    if not segments:
        raise ValueError("segmented path: no CONV+POOL segment in the chain")
    return segments


def build_segmented_request(specs, plans, params, *, strict: bool = False,
                            cache=None, backend: str = "torch",
                            opt_level: int = 1, device=None):
    """The legacy multi-Program path: one compiled Program per CONV segment,
    a host-side 2x2 maxpool between segments, and the FC tail outside the
    runtime (``hybrid_conv.dense``: K2 on ``backend="hopper"``). Kept as
    ``Accelerator.build(..., segmented=True)``. ``strict=True`` builds the
    segment runtimes on the per-instruction interpreter; ``cache``
    overrides the process-wide program cache for every segment runtime;
    ``backend`` selects the PE of the segment runtimes AND the FC tail;
    ``opt_level`` is each segment executor's lowering level; ``device``
    (``None`` = the CUDA card) is where the weights and requests live.
    Returns ``(request, runtimes, n_instructions)``."""
    resolve_backend(backend)       # reject bad knobs before building
    resolve_opt_level(opt_level)
    device = resolve_device(device)

    # params align with the non-pool specs, in network order
    nonpool = [s for s in specs if not isinstance(s, PoolSpec)]
    if len(nonpool) != len(params):
        raise ValueError(f"segmented path: {len(params)} param pairs for "
                         f"{len(nonpool)} CONV/FC layers")
    conv_specs = [s for s in specs if isinstance(s, ConvSpec)]
    conv_plans = [p for s, p in zip(specs, plans) if isinstance(s, ConvSpec)]
    conv_params = [p for s, p in zip(nonpool, params)
                   if isinstance(s, ConvSpec)]
    pool_specs = [s for s in specs if isinstance(s, PoolSpec)]
    fc_specs = [s for s in nonpool if isinstance(s, FCSpec)]
    fc_params = [tuple(to_tensor(a, device) for a in p)
                 for s, p in zip(nonpool, params) if isinstance(s, FCSpec)]

    runtimes, idx, n_instr = [], 0, 0
    for n in _conv_segments_of(specs):
        program = compile_network(conv_specs[idx:idx + n],
                                  conv_plans[idx:idx + n])
        rt = HybridRuntime(program, strict=strict, cache=cache,
                           backend=backend, opt_level=opt_level,
                           device=device)
        rt.load_params(conv_params[idx:idx + n])
        runtimes.append(rt)
        n_instr += len(program.instructions)
        idx += n

    def request(x):
        x = to_tensor(x, device, torch.float32)
        with torch.no_grad():
            for rt, ps in zip(runtimes, pool_specs):
                x = max_pool2d(rt.run(x), ps.window, ps.stride).contiguous()
            x = x.reshape(x.shape[0], -1)
            for s, (w, b) in zip(fc_specs, fc_params):
                x = dense(x, w, b, relu=s.relu, backend=backend)
        return x

    return request, runtimes, n_instr


# ---------------------------------------------------------------------------
# Program (de)serialization helpers
# ---------------------------------------------------------------------------

_SPEC_KINDS = {"conv": ConvSpec, "pool": PoolSpec, "fc": FCSpec,
               "eltwise": EltwiseSpec, "dw": DepthwiseSpec}


def _spec_to_dict(spec) -> dict:
    kind = next(k for k, cls in _SPEC_KINDS.items()
                if type(spec) is cls)
    return {"kind": kind, **dataclasses.asdict(spec)}


def _spec_from_dict(d: dict):
    d = dict(d)
    return _SPEC_KINDS[d.pop("kind")](**d)


def _hw_to_dict(hw) -> dict:
    if isinstance(hw, TPUCandidate):
        return {"type": "tpu", **dataclasses.asdict(hw)}
    if isinstance(hw, FPGACandidate):
        return {"type": "fpga", **dataclasses.asdict(hw)}
    return {"type": "other", "repr": repr(hw)}


def _hw_from_dict(d: dict):
    d = dict(d)
    typ = d.pop("type")
    if typ == "tpu":
        return TPUCandidate(**d)
    if typ == "fpga":
        return FPGACandidate(**d)
    return d.get("repr")


def _pow2_buckets(max_batch: int) -> list[int]:
    """The default session buckets: powers of two below ``max_batch``,
    then ``max_batch`` itself."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    return buckets + [max_batch]


def _fmt_t(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:8.1f} us"
    if seconds < 1.0:
        return f"{seconds * 1e3:8.2f} ms"
    return f"{seconds:8.3f} s "


# ---------------------------------------------------------------------------
# The façade
# ---------------------------------------------------------------------------

class Accelerator:
    """A built accelerator: DSE verdict + ONE compiled Program (or, when
    segmented, one per CONV segment) + the cached, validated executor behind
    ``__call__``, on one device.

    Construct with :meth:`build` (the full flow) or :meth:`from_program`
    (reuse a saved instruction stream, skipping the DSE). :meth:`summary`
    prints the per-layer DSE verdict, :meth:`save_program` persists the
    compiled stream, and :meth:`serve` opens a batching
    :class:`ServingSession`."""

    def __init__(self, *, specs, plans, params, request, device,
                 target=None, batch: int = 1,
                 program: Program | None = None,
                 runtime: HybridRuntime | None = None,
                 dse: DSEResult | None = None, segmented: bool = False,
                 segment_runtimes: list | None = None,
                 backend: str = "torch", opt_level: int = 1,
                 quant: QuantSidecar | None = None,
                 calib_ms: float | None = None):
        self.specs = list(specs)
        self.plans = list(plans)
        self.params = params
        self.target = target
        self.batch = batch
        self.program = program
        self.runtime = runtime
        self.dse = dse
        self.segmented = segmented
        self.segment_runtimes = segment_runtimes
        self.backend = backend
        self.opt_level = opt_level
        self.device = device
        self.quant = quant          # QuantSidecar for int8 accelerators
        self.calib_ms = calib_ms    # host time of the int8 calibration
        self._request = request

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, specs, target: Target = pm.V5E, *, batch: int = 8,
              params: list | None = None, seed: int = 0,
              plans: Sequence[LayerPlan | None] | None = None,
              segmented: bool = False, strict: bool = False,
              cache=None, backend: str = "torch", opt_level: int = 1,
              dtype: str = "float32", calib=None,
              observer: str = "percentile", device=None) -> "Accelerator":
        """DSE -> compile -> validate -> load weights, in one call.

        ``plans`` overrides the DSE; ``params`` defaults to
        :func:`random_params` (``seed``). ``backend`` selects the PE and
        ``opt_level`` the lowering optimizer; both join the program-cache
        key. ``device=None`` resolves to CUDA and raises without it.

        ``dtype="int8"`` builds a quantized accelerator: the DSE plans
        against the target's int8 variant (Winograd gated off), ``calib``
        (an (n, H, W, C) array or a list of batches; by default seeded
        random data, bit for bit the reference's) drives post-training
        calibration into a ``QuantSidecar`` (``observer``: ``"percentile"``
        or ``"minmax"``), and the params are quantized (int8 weights, int32
        biases). ``__call__`` stays float-in/float-out.

        ``strict=True`` answers every request through the per-instruction
        interpreter (on ``backend``'s PE) and skips the build-time schedule
        validation: the interpreter checks the hazards per instruction.
        ``segmented=True`` builds the legacy multi-Program path instead
        (:func:`build_segmented_request`; fp32 only).
        """
        if dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported dtype {dtype!r}: expected "
                             f"'float32' or 'int8'")
        if dtype == "int8" and segmented:
            raise ValueError("segmented accelerators are fp32-only — the "
                             "int8 path needs the single-Program runtime "
                             "(the sidecar is keyed to one schedule)")
        device = resolve_device(device)
        specs = list(specs)
        build_id = spans.new_id()
        with spans.span(spans.BUILD, build_id, count=batch):
            dse = None
            if plans is None:
                if not isinstance(target, Target):
                    raise TypeError(
                        f"target {target!r} does not implement the Target "
                        f"protocol (needs a run_dse(specs, batch) method) — "
                        f"pass e.g. pm.V5E, pm.VU9P, pm.PYNQ_Z1, or supply "
                        f"plans=")
                # dtype is only passed when quantizing, so custom fp32
                # targets without the dtype parameter keep working
                with spans.span(spans.BUILD_DSE, parent=build_id):
                    dse = (target.run_dse(specs, batch=batch, dtype=dtype)
                           if dtype != "float32"
                           else target.run_dse(specs, batch=batch))
                plans = list(dse.plans)
            else:
                plans = list(plans)
            if params is None:
                params = random_params(specs, seed, device)

            quant, calib_ms = None, None
            if dtype == "int8":
                if calib is None:
                    # stand-in calibration data, seeded like random_params
                    s0 = specs[0]
                    shape = ((8, s0.d_in) if isinstance(s0, FCSpec)
                             else (8, s0.h, s0.w, s0.c))
                    calib = np.random.default_rng(seed + 1).standard_normal(
                        shape).astype(np.float32)
                with spans.span(spans.BUILD_CALIBRATE, parent=build_id):
                    t0 = time.perf_counter()
                    quant = calibrate(specs, params, calib,
                                      observer=observer, device=device)
                    calib_ms = (time.perf_counter() - t0) * 1e3
                    params = quantize_params(specs, params, quant,
                                             device=device)

            common = dict(specs=specs, plans=plans, params=params,
                          target=target, batch=batch, dse=dse,
                          backend=backend, opt_level=opt_level,
                          device=device)
            if segmented:
                with spans.span(spans.BUILD_COMPILE, parent=build_id):
                    request, seg_rts, _ = build_segmented_request(
                        specs, plans, params, strict=strict, cache=cache,
                        backend=backend, opt_level=opt_level, device=device)
                return cls(request=request, segmented=True,
                           segment_runtimes=seg_rts, **common)

            with spans.span(spans.BUILD_COMPILE, parent=build_id):
                program = compile_network(specs, plans)
                rt = HybridRuntime(program, backend=backend,
                                   opt_level=opt_level, strict=strict,
                                   cache=cache, device=device, quant=quant)
            with spans.span(spans.BUILD_LOAD, parent=build_id):
                rt.load_params(params)
            if not strict:
                # schedule check once, at build time
                with spans.span(spans.BUILD_VALIDATE, parent=build_id):
                    rt.cache.validate(program)
            return cls(request=rt.run, program=program, runtime=rt,
                       quant=quant, calib_ms=calib_ms, **common)

    # -- inference ----------------------------------------------------------
    def __call__(self, x) -> torch.Tensor:
        """One inference request. ``x``: (n, H, W, C) for CONV-first models,
        (n, D) for FC-first, as an array or tensor; runs on the
        accelerator's device. Quantized accelerators are float-in/float-out:
        float inputs are quantized at the calibrated input scale (int8
        inputs pass through) and the int8 logits are dequantized."""
        if self.quant is not None:
            y = self._request(to_tensor(x, self.device))
            return self.quant.dequantize_output(y)
        return self._request(to_tensor(x, self.device, torch.float32))

    @property
    def input_dtype(self) -> torch.dtype:
        """The stored weight type: float32, or int8 when quantized."""
        if self.runtime is None:
            return torch.float32       # segmented: fp32 only
        params = self.runtime.dram_params()
        return params[0][0].dtype if params else torch.float32

    @property
    def input_shape(self) -> tuple[int, ...]:
        """Shape of ONE request item (no batch dim)."""
        s0 = self.specs[0]
        if isinstance(s0, FCSpec):
            return (s0.d_in,)
        return (s0.h, s0.w, s0.c)

    @property
    def n_instructions(self) -> int:
        if self.program is not None:
            return len(self.program.instructions)
        return sum(len(rt.program.instructions)
                   for rt in self.segment_runtimes or [])

    def strict_request(self):
        """A per-instruction-interpreter request fn over the same Program(s)
        and params, on this accelerator's device: the hazard-faithful
        baseline for comparisons. It always runs the ``torch`` PE, whatever
        this accelerator's ``backend``, so it is the oracle for the
        ``hopper`` path too. A quantized accelerator's interpreter carries
        the same sidecar, so its int8 outputs compare bit for bit with the
        raw executor's (``runtime.run``)."""
        if self.segmented:
            return build_segmented_request(
                self.specs, self.plans, self.params, strict=True,
                device=self.device)[0]
        rt = HybridRuntime(self.program, strict=True, device=self.device,
                           quant=self.quant)
        rt.load_params(self.params)
        return rt.run

    # -- reporting ----------------------------------------------------------
    def _hw_desc(self) -> str:
        if self.dse is None:
            return "plans supplied (no DSE)"
        hw = self.dse.hw
        if isinstance(hw, TPUCandidate):
            return (f"blocks=({hw.bm},{hw.bk},{hw.bn}) m={hw.m} | DSE over "
                    f"{self.dse.candidates_searched} candidates")
        if isinstance(hw, FPGACandidate):
            return (f"PI={hw.pi} PO={hw.po} PT={hw.pt} NI={hw.ni} | DSE over "
                    f"{self.dse.candidates_searched} candidates")
        return str(hw)

    def summary(self) -> str:
        """Per-layer plan/latency table — the DSE verdict, human-readable;
        the reference's text character for character."""
        # target is an instance with .name, or the bare name string a
        # from_program-restored accelerator carries
        tname = (self.target if isinstance(self.target, str)
                 else getattr(self.target, "name", None)) or "-"
        kind_of = {ConvSpec: "conv", PoolSpec: "pool", FCSpec: "fc",
                   EltwiseSpec: "eltwise", DepthwiseSpec: "dw"}
        head = (f"{len(self.specs)} layers as "
                + (f"{len(self.segment_runtimes)} segment Programs + host "
                   f"glue" if self.segmented else
                   f"ONE Program ({self.n_instructions} instructions)"))
        lines = [f"Accelerator[{tname}]: {head}",
                 f"  {self._hw_desc()}, batch={self.batch}",
                 f"  {'layer':<12}{'kind':<9}{'dtype':<9}{'mode':<6}"
                 f"{'df':<4}{'m':>2}{'g_h':>5}{'g_k':>5}"
                 f"  {'latency':>11}{'share':>8}"]
        lats = self.dse.layer_latencies if self.dse else None
        total = self.dse.total_latency if self.dse else None
        for i, (s, p) in enumerate(zip(self.specs, self.plans)):
            kind = kind_of[type(s)]
            p = p or NO_PLAN
            mode, df, m = (p.mode, p.dataflow, str(p.m)) \
                if kind == "conv" else ("-", "-", "-")
            gh, gk = ((str(p.g_h), str(p.g_k)) if kind == "conv"
                      else ("-", "-"))
            # precision per layer: "int8+rq" = int8 math with the fused
            # requantize epilogue, "int8" = scale-passthrough (pool)
            if self.quant is None:
                dt = "fp32"
            else:
                dt = ("int8+rq" if self.quant.layers[i].requantize
                      else "int8")
            lat = _fmt_t(lats[i]) if lats else "          -"
            share = (f"{100 * lats[i] / total:6.1f}%"
                     if lats and total else "      -")
            lines.append(f"  {s.name:<12}{kind:<9}{dt:<9}{mode:<6}{df:<4}"
                         f"{m:>2}{gh:>5}{gk:>5}  {lat}{share}")
        if total is not None:
            macs = sum(s.macs for s in self.specs)
            scale = self.batch if isinstance(self.dse.hw, TPUCandidate) else 1
            gops = 2.0 * macs * scale / total / 1e9
            lines.append(f"  est. total {_fmt_t(total).strip()} "
                         f"({gops:.1f} effective GOPS)")
        return "\n".join(lines)

    # -- persistence --------------------------------------------------------
    def save_program(self, path: str, *, aot: bool = False,
                     buckets: Sequence[int] | None = None) -> str:
        """Persist the compiled instruction stream + specs/plans + DSE
        verdict (+ the int8 sidecar, digest-bound to this schedule) as the
        reference's ``hybriddnn-program/v1`` JSON document, key for key, so
        :meth:`from_program` — of either package — rebuilds this
        accelerator without re-running the DSE. Params are NOT saved (they
        are the model's weights — supply them at load time).

        ``aot=True`` writes a **bundle directory** instead: ``program.json``
        (the same document) plus ``aot/`` holding one ``torch.export``
        artifact per executor entry — every serving ``bucket`` with
        ``donate_input=True`` (the :class:`ServingSession` hot path;
        default: the session's power-of-two buckets up to ``self.batch``)
        and the direct entry at ``self.batch`` with ``False``. A bundle
        loaded by :meth:`from_program` serves without lowering; see
        ``repro_torch.core.aot`` for the keying and fallback."""
        if self.program is None:
            raise ValueError("segmented accelerators hold multiple Programs; "
                             "save_program supports the single-Program path")
        doc = {
            "format": PROGRAM_FORMAT,
            "target": (self.target if isinstance(self.target, str)
                       else getattr(self.target, "name", None)),
            "batch": self.batch,
            "specs": [_spec_to_dict(s) for s in self.specs],
            "plans": [dataclasses.asdict(cl.plan)
                      for cl in self.program.layers],
            "instructions": self.program.instruction_image().tolist(),
            "dse": None if self.dse is None else {
                "hw": _hw_to_dict(self.dse.hw),
                "layer_latencies": [float(v)
                                    for v in self.dse.layer_latencies],
                "total_latency": float(self.dse.total_latency),
                "candidates_searched": self.dse.candidates_searched,
            },
            # the sidecar rides beside the instruction stream (int8 never
            # changes the ISA); its digest binds it to this schedule, so a
            # sidecar pasted from another calibration is refused at load
            "quant": None if self.quant is None else {
                "sidecar": self.quant.to_dict(),
                "digest": self.quant.digest(self.program.schedule_key()),
            },
        }
        if not aot:
            with open(path, "w") as f:
                json.dump(doc, f)
            return path
        rt = self.runtime
        if rt is None or rt.strict:
            raise ValueError("aot=True needs the cached-executor runtime — "
                             "strict-interpreter accelerators have no "
                             "compiled executable to export")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "program.json"), "w") as f:
            json.dump(doc, f)
        aot_dir = os.path.join(path, "aot")
        if buckets is None:
            buckets = _pow2_buckets(self.batch)
        in_shape = tuple(self.input_shape)
        dt = self.input_dtype
        for b in sorted({int(b) for b in buckets}):
            # the serving hot path: bucket entries take the staged input
            rt.export_aot(aot_dir, (b, *in_shape), dt, donate_input=True)
        # the direct acc(x) path: batch-sized, no donation
        rt.export_aot(aot_dir, (self.batch, *in_shape), dt,
                      donate_input=False)
        return path

    @classmethod
    def from_program(cls, path: str, *, params: list | None = None,
                     strict: bool = False, cache=None,
                     backend: str = "torch", opt_level: int = 1,
                     device=None) -> "Accelerator":
        """Rebuild an accelerator from a saved program — no DSE.

        The layer chain is recompiled from the saved specs/plans and the
        stream is verified bit for bit against the saved instruction image.
        ``params`` is required: saved programs carry no weights (pass
        ``api.random_params(specs, seed)`` for stand-ins); an int8 program
        takes fp32 weights (quantized here by the sidecar's scales) or the
        quantized image. ``backend``/``opt_level``/``device`` are chosen
        as in :meth:`build`: the saved stream is agnostic to all three.

        ``path`` may be a directory holding ``program.json``: an AOT
        bundle written by ``save_program(..., aot=True)``, whose ``aot/``
        the runtime loads executor entries from whenever the full artifact
        key (this host's device, torch and CUDA versions and kernel digest
        included) matches; stale artifacts fall back to a fresh build with
        the reason logged on ``repro_torch.aot``. Malformed input —
        truncated/non-JSON file, unknown format version, instruction-stream
        drift, a quant sidecar whose digest is bound to another schedule,
        a directory without ``program.json`` — raises
        :class:`ProgramLoadError`.
        """
        if params is None:
            raise ValueError(
                "saved programs carry no weights — pass params=[...] "
                "(api.random_params(specs, seed) for stand-ins)")
        aot_dir = None
        doc_path = path
        if os.path.isdir(path):
            doc_path = os.path.join(path, "program.json")
            if not os.path.exists(doc_path):
                raise ProgramLoadError(
                    f"{path}: directory is not an AOT bundle — no "
                    f"program.json inside")
            d = os.path.join(path, "aot")
            aot_dir = d if os.path.isdir(d) else None
        try:
            with open(doc_path) as f:
                doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ProgramLoadError(
                f"{doc_path}: truncated or not JSON ({e}) — the save was "
                f"interrupted or the file corrupted in transit") from e
        if doc.get("format") != PROGRAM_FORMAT:
            raise ProgramLoadError(
                f"{doc_path}: not a {PROGRAM_FORMAT} file "
                f"(format={doc.get('format')!r})")
        device = resolve_device(device)
        specs = [_spec_from_dict(d) for d in doc["specs"]]
        plans = [LayerPlan(**d) for d in doc["plans"]]
        program = compile_network(specs, plans)
        image = np.asarray(doc["instructions"], np.uint32).reshape(-1, 4)
        if not np.array_equal(program.instruction_image(), image):
            raise ProgramLoadError(
                f"{doc_path}: saved instruction stream does not match its "
                f"recompilation (compiler or schedule drift) — re-run "
                f"Accelerator.build and save again")
        params = [tuple(to_tensor(a, device) for a in p) for p in params]
        quant = None
        if doc.get("quant"):
            q = doc["quant"]
            quant = QuantSidecar.from_dict(q["sidecar"])
            if quant.digest(program.schedule_key()) != q.get("digest"):
                raise ProgramLoadError(
                    f"{doc_path}: quant sidecar digest does not match this "
                    f"program's schedule — the sidecar was edited or "
                    f"belongs to a different calibration/program; re-run "
                    f"Accelerator.build(dtype='int8') and save again")
            # fp32 weights are quantized here, deterministically (the
            # sidecar fixes every scale); an int8 image passes through
            if params[0][0].dtype != torch.int8:
                params = quantize_params(specs, params, quant, device=device)
        dse = None
        if doc.get("dse"):
            d = doc["dse"]
            dse = DSEResult(hw=_hw_from_dict(d["hw"]), plans=plans,
                            layer_latencies=d["layer_latencies"],
                            total_latency=d["total_latency"],
                            candidates_searched=d["candidates_searched"])
        rt = HybridRuntime(program, backend=backend, opt_level=opt_level,
                           strict=strict, cache=cache, device=device,
                           quant=quant, aot_dir=aot_dir)
        rt.load_params(params)
        if not strict:
            rt.cache.validate(program)
        return cls(specs=specs, plans=plans, params=params, request=rt.run,
                   device=device, target=doc.get("target"),
                   batch=doc.get("batch", 1), program=program, runtime=rt,
                   dse=dse, backend=backend, opt_level=opt_level,
                   quant=quant)

    # -- serving ------------------------------------------------------------
    def serve(self, **kwargs) -> "ServingSession":
        """Open a :class:`ServingSession` over this accelerator — a
        padding-bucketed request-batching queue (see the class docs).
        ``mesh="host"`` shards batches over every local device of the
        accelerator's kind (``launch.mesh.make_host_mesh``)."""
        return ServingSession(self, **kwargs)


# ---------------------------------------------------------------------------
# Serving: the request-batching queue (NI-instances analog)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SessionStats:
    requests: int = 0        # requests completed
    batches: int = 0         # executor invocations
    padded_rows: int = 0     # zero rows added to reach a bucket size
    dispatched_rows: int = 0  # real (non-pad) rows sent to the device
    # -- failure model -----------------------------------------------------
    # the accounting invariant every session maintains and the chaos soak
    # asserts: submitted == requests + errors + shed. A request lands in
    # exactly one of the three; deadline_exceeded is the subset of errors
    # failed by the deadline enforcer, isolated the subset quarantined
    # individually (poisoned-batch bisection or a numerics guard hit).
    submitted: int = 0           # requests accepted by submit()/run_many()
    errors: int = 0              # requests resolved with an exception
    deadline_exceeded: int = 0   # ... of which: missed their deadline_ms
    shed: int = 0                # refused at admission (queue_limit)
    retries: int = 0             # bisection re-dispatches after a failure
    isolated: int = 0            # requests individually quarantined
    # the reference's pallas -> xla re-runs; kept for the stats surface, it
    # stays 0: a failed hopper batch is bisected, never re-run on aten
    degraded: int = 0
    watchdog_restarts: int = 0   # pipeline restarts after a dead thread
    # first-use cost per bucket (warmup or first batch): on the card the
    # entry's warm-up run and CUDA-graph capture, and the kernel library's
    # build on the first launch of the process. It counts to warm_load_ms
    # when the bucket's entry was loaded from an AOT bundle (with the
    # artifact's load when the session opens), to compile_ms otherwise.
    compile_ms: float = 0.0
    warm_load_ms: float = 0.0
    # batches dispatched per device: keyed by the device index on an
    # unsharded session, by the replica's position in the mesh on a sharded
    # one (a sharded batch counts on every position, a straggler on
    # position 0; on make_fleet_mesh the position is the device index)
    device_batches: dict = dataclasses.field(default_factory=dict)
    # the session's id in the span log (``repro_torch.spans``), whose
    # ``serving.request`` spans the latency and wait percentiles read
    session: int = 0
    # guards the counters bumped from several threads
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    def bump(self, name: str, k: int = 1):
        """Thread-safe counter increment — the failure counters are bumped
        from the worker, drain, supervisor AND caller threads, and a bare
        ``+=`` read-modify-write can drop updates across them."""
        with self._lock:
            setattr(self, name, getattr(self, name) + k)

    def _samples_ms(self, t0, t1, wait: bool) -> list[float] | None:
        """Per request of the session answered and submitted inside
        ``[t0, t1]`` (everything the log holds of it when ``t0`` is
        None): its latency (submit -> result), or its wait (submit -> its
        batch's launch). None when the log no longer holds ``t0``."""
        got = spans.LOG.between(t0, math.inf if t1 is None else t1)
        if got is None:
            return None
        lo = -math.inf if t0 is None else t0
        hi = math.inf if t1 is None else t1
        mine = [s for s in got if s.session == self.session]
        reqs = [s for s in mine
                if s.name == spans.REQUEST and lo <= s.t0 <= hi]
        if not wait:
            return [(s.t1 - s.t0) * 1e3 for s in reqs]
        launch = {s.id: s.t0 for s in mine if s.name == spans.LAUNCH}
        return [(launch[s.parent] - s.t0) * 1e3 for s in reqs
                if s.parent in launch]

    def _pct(self, q: float, t0, t1, wait: bool = False) -> float:
        xs = self._samples_ms(t0, t1, wait)
        if xs is None:
            return math.nan
        if not xs:
            return 0.0
        xs.sort()
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def p50_ms(self, t0: float | None = None,
               t1: float | None = None) -> float:
        """Median request latency (submit -> result) over the requests
        submitted in ``[t0, t1]`` (``spans.clock`` seconds; by default
        every one the span log still holds); NaN when the log no longer
        holds ``t0``, 0.0 when no request was answered."""
        return self._pct(0.50, t0, t1)

    def p95_ms(self, t0: float | None = None,
               t1: float | None = None) -> float:
        """95th-percentile request latency, as :meth:`p50_ms`."""
        return self._pct(0.95, t0, t1)

    def wait_p50_ms(self, t0: float | None = None,
                    t1: float | None = None) -> float:
        """Median queue wait (submit -> its batch's launch), as
        :meth:`p50_ms`."""
        return self._pct(0.50, t0, t1, wait=True)

    def wait_p95_ms(self, t0: float | None = None,
                    t1: float | None = None) -> float:
        """95th-percentile queue wait, as :meth:`wait_p50_ms`."""
        return self._pct(0.95, t0, t1, wait=True)

    def occupancy(self) -> float:
        """Real-row fraction of all dispatched device rows (1.0 = no
        padding waste)."""
        total = self.dispatched_rows + self.padded_rows
        return self.dispatched_rows / total if total else 1.0


class _SlotPool:
    """FIFO-fair counting semaphore over device-pipeline slots.

    Each :class:`ServingSession` bounds its outstanding device batches with
    one of these (the classic triple buffer: one syncing, one executing,
    one staged). A :class:`Fleet` shares ONE pool across every tenant
    session, so device time round-robins between models: dispatch workers
    queue FIFO for the next free slot.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("slot pool capacity must be >= 1")
        self.capacity = int(capacity)
        self._free = self.capacity
        self._cv = threading.Condition()
        self._waiters: deque = deque()
        self._subscribers: list[threading.Condition] = []

    def subscribe(self, cv: threading.Condition):
        """Register a condition to notify on every release — session
        admitters sleep on their own ``_cv`` while the pipeline is full, so
        a freed slot must wake them there."""
        with self._cv:
            self._subscribers.append(cv)

    def busy(self) -> bool:
        """Lock-free hint: any slot taken — the device still has dispatched
        work in flight."""
        return self._free < self.capacity

    def acquire(self, cancelled=None, blocking: bool = True) -> bool:
        """Block for a slot; returns True once acquired. ``cancelled`` (a
        nullary predicate, polled while waiting) lets a dispatch worker
        abandon the wait when its pipeline generation is retired. Returns
        False when cancelled. ``blocking=False`` takes a slot only when one
        is free and nobody queues ahead, else returns False at once."""
        token = object()
        with self._cv:
            if not blocking:
                if self._free <= 0 or self._waiters:
                    return False
                self._free -= 1
                return True
            self._waiters.append(token)
            while self._free <= 0 or self._waiters[0] is not token:
                if cancelled is not None and cancelled():
                    self._waiters.remove(token)
                    self._cv.notify_all()   # next in line may now be eligible
                    return False
                self._cv.wait(None if cancelled is None else 0.05)
            self._waiters.popleft()
            self._free -= 1
            if self._free > 0:
                self._cv.notify_all()   # next waiter in line may also go
            return True

    def release(self):
        with self._cv:
            # clamp: watchdog crash-recovery frees slots on behalf of dead
            # threads; a presumed-dead thread's late release must not
            # inflate the pool past its capacity
            self._free = min(self._free + 1, self.capacity)
            self._cv.notify_all()
        for cv in self._subscribers:
            with cv:
                cv.notify_all()


class _Request:
    """One staged request flowing through the session pipeline."""

    __slots__ = ("x", "single", "fut", "t_submit", "rid", "deadline",
                 "deadline_ms", "off")

    def __init__(self, x, single: bool, fut: Future | None,
                 t_submit: float, rid: int,
                 deadline: float | None = None,
                 deadline_ms: float | None = None):
        self.x = x                    # staged host array (k, *input_shape)
        self.single = single          # un-batched submit: scatter row 0
        self.fut = fut                # None on run_many's inline bulk path
        self.t_submit = t_submit
        self.rid = rid                # session-unique id (fault targeting)
        self.deadline = deadline      # absolute monotonic, None = none
        self.deadline_ms = deadline_ms
        self.off = 0                  # row offset inside its staged bucket


class _Stage:
    """One staging entry of a bucket: a host input buffer (pinned on a CUDA
    session, so its copy to the card is asynchronous), a device input
    buffer for a bucket served through ``acc(x)`` (segmented and strict
    accelerators; an executor entry copies the pinned buffer straight into
    its CUDA graph's static input) and a pinned host buffer for the
    logits, made at warmup or at the entry's first batch.

    An entry is bound to one pipeline slot: taken when its batch is staged
    and given back only where that batch's slot is released. ``fence`` is
    an event recorded when an entry comes back before its batch's copies
    were waited for (a failed launch or drain); the next taker waits on it
    before refilling the buffers."""

    __slots__ = ("host_t", "host", "dev", "out", "fence")

    def __init__(self, shape, dtype: torch.dtype, device: torch.device,
                 device_buffer: bool):
        pin = device.type == "cuda"
        self.host_t = torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.host = self.host_t.numpy()   # the numpy view callers fill
        self.dev = (torch.empty(shape, dtype=dtype, device=device)
                    if device_buffer else None)
        self.out: torch.Tensor | None = None
        self.fence = None


class _InFlight:
    """A launched batch's logits: on the card the asynchronous copy into a
    pinned host buffer and the event recorded after it on the session's
    stream (the drainer waits on this event only, never on the stream),
    on the CPU the logits themselves (``event`` None). ``bid`` is the
    batch's id in the span log; ``ev0`` the timed event recorded before
    its copy in while ``spans.on()`` (``event`` is then timed too);
    ``t_drained`` when its wait ended, where its ``serving.deliver`` span
    (profiler range ``rng``) begins."""

    __slots__ = ("out", "event", "bid", "ev0", "t_drained", "rng")

    def __init__(self, out: torch.Tensor, event, bid: int, ev0=None):
        self.out = out
        self.event = event
        self.bid = bid
        self.ev0 = ev0
        self.t_drained = 0.0
        self.rng = None


_NUMPY_DTYPES = {torch.float32: np.float32, torch.int8: np.int8}


@contextlib.contextmanager
def settled_heap():
    """Serve inside this block from a settled heap: one full garbage
    collection first, then every object alive at that point is frozen
    out of the collector until the block ends (``gc.freeze``). A full
    collection stops every thread of the process; over an unsettled heap
    it took 83-237 ms on the H100 host, long enough to queue a window's
    slowest twentieth of requests behind it (``PERF.md`` §6). Wrap
    the traffic of a serving process after its accelerators are built and
    warm (the serve CLI's ``--session`` does); the freeze is process-wide,
    so do not nest it."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


class ServingSession:
    """Padding-bucketed request-batching queue over the cached executor,
    with pipelined dispatch.

    Callers ``submit()`` single items (H, W, C) or small batches
    (n, H, W, C) and get a ``Future``; a dispatch worker coalesces pending
    requests into device batches of at most ``max_batch`` items, pads each
    batch up to the nearest size in ``buckets`` (one cached executor per
    bucket), runs the accelerator's executor entry directly, and scatters
    the rows back to the futures in submission order.

    The hot path is **pipelined**, the software analog of the paper's
    LOAD/COMP/SAVE overlap. The dispatch worker stages a batch in a pinned
    host buffer and hands it to the bucket's executor entry
    (``donate_input=True``), which copies it (``non_blocking``) straight
    into its CUDA graph's static input and replays the graph; the worker
    then enqueues the logits' copy into a pinned host buffer and records a
    CUDA event — all on ONE stream per device (the one current when the
    session opened), since the kernels and the graph replays read the
    thread's current stream, and every batch of a bucket shares the
    graph's static buffers, which only that stream's order keeps apart. A
    separate drain thread waits on each batch's event only and resolves
    its futures, so host staging of batch i+1 overlaps the
    device work of batch i. Outstanding device batches are hard-capped at
    the slot pool's capacity (3: one being drained, one executing, one
    staged). Each batch stages into an entry bound to its pipeline slot:
    taken from the bucket's free list when the batch is staged, given back
    only where the batch's slot is released (its logits copied out), so no
    copy in flight ever reads or writes a buffer being refilled, whatever
    order batches complete in (concurrent ``run_many`` callers, failures).

    The session inherits the accelerator's PE ``backend`` and lowering
    ``opt_level``: per-bucket executors come from
    ``HybridRuntime.executor_entry``. Segmented and strict accelerators
    serve through ``acc(x)``. On the CPU the same pipeline runs
    synchronously (no pinned memory, no events).

    ``mesh`` (``None``, ``"host"``, a :class:`repro_torch.compat.Mesh` or a
    sequence of devices, one replica each; a device may repeat) shards
    every bucket that divides over its ``n`` positions: the session takes
    the sharded entry for it (``executor.ShardedExecutor``: each position
    runs its shard as an ordinary single-device entry on that device's
    session stream, the logits are gathered on the mesh's first device,
    whose stream waits on an event of every other device's stream, and the
    batch's one event after the gather marks all of them done), and the
    single-device entries serve the stragglers. A mesh of one position
    serves unsharded. The weights are replicated once, when the session
    opens. Segmented and strict accelerators cannot shard, and a mesh that
    divides no bucket is refused (``ValueError`` both). With a repeated
    device the shards take turns on its stream; that shows the split, the
    gather and the bookkeeping, not scaling.

    ``scheduler`` selects the admission policy:

    * ``"continuous"`` (default) — the admitter fills the next in-flight
      device batch straight from the pending queue. The batching window
      (``max_wait_ms``) only caps the wait while a device slot is FREE;
      while the pipeline is full it keeps admitting into the open batch.
    * ``"bucketed"`` — the legacy fixed-window policy: cut the batch when
      the window expires regardless of pipeline state.

    ``stats`` records request/batch counts, the first-use time of each
    bucket (``compile_ms``, or ``warm_load_ms`` for an entry loaded from an
    AOT bundle), per-device batch counts and padding ``occupancy()``, and
    reads per-request latency (``p50_ms()`` / ``p95_ms()``) and queue wait
    (``wait_p50_ms()``) over any interval from the session's spans in
    ``repro_torch.spans.LOG``: each batch's admission, slot wait, staging,
    launch, drain and delivery, and each request from ``submit`` to its
    result, recorded always (and, while a ``torch.profiler`` records or
    inside ``spans.recording()``, as profiler ranges too). ``slot_pool``
    shares the pipeline slots with other sessions (a :class:`Fleet`).

    **Failure model** (the reference's):

    * ``deadline_ms`` (session default, overridable per ``submit``) — a
      request not drained by its deadline resolves with
      :class:`repro_torch.serving.DeadlineExceeded`.
    * ``queue_limit`` + ``on_overload`` (``"shed"`` | ``"block"``) —
      bounded admission: past the limit, ``"shed"`` returns a future
      pre-failed with :class:`repro_torch.serving.Overloaded`; ``"block"``
      makes ``submit`` wait for queue space.
    * poisoned-batch isolation — a failed coalesced batch is bisected and
      re-dispatched at the SAME bucket size with the excluded rows zeroed
      in place, so innocent co-batched requests still succeed bit for bit
      as in a fault-free run; the offender fails with the causal exception
      (``stats.retries`` / ``stats.isolated``).
    * no backend degradation — the reference re-runs a failed ``pallas``
      batch on ``xla``; here a failed ``hopper`` batch goes straight to
      bisection and typed errors, never to the aten lowering
      (``stats.degraded`` stays 0).
    * ``guard_numerics`` — per-request NaN/Inf quarantine at drain time
      (:class:`repro_torch.serving.NumericsError`).
    * supervision — a per-session watchdog thread enforces deadlines and
      watches the dispatch/drain threads; a dead (or, with
      ``hang_after_s``, silent) thread fails every queued/in-flight future
      with :class:`repro_torch.serving.PipelineCrashed`, frees its slots
      and restarts the pipeline (``stats.watchdog_restarts``).
    * ``fault_plan`` — a :class:`repro_torch.serving.FaultPlan` wired into
      the pipeline boundaries for deterministic fault injection.

    The accounting invariant across all of the above:
    ``stats.submitted == stats.requests + stats.errors + stats.shed``
    once every accepted future has resolved.
    """

    SCHEDULERS = ("continuous", "bucketed")

    def __init__(self, acc: Accelerator, *, max_batch: int = 8,
                 buckets: Sequence[int] | None = None, mesh=None,
                 max_wait_ms: float = 5.0, warmup: bool = False,
                 scheduler: str = "continuous",
                 slot_pool: _SlotPool | None = None,
                 deadline_ms: float | None = None,
                 queue_limit: int | None = None,
                 on_overload: str = "shed",
                 guard_numerics: bool = False,
                 fault_plan=None,
                 supervise: bool = True,
                 hang_after_s: float | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if scheduler not in self.SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}: expected "
                             f"one of {self.SCHEDULERS}")
        if on_overload not in ("shed", "block"):
            raise ValueError(f"on_overload must be 'shed' or 'block', "
                             f"got {on_overload!r}")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        self._device = acc.device
        self._mesh = _session_mesh(mesh, self._device)
        self._n_devices = mesh_device_count(self._mesh)
        self.acc = acc
        self.scheduler = scheduler
        self.max_batch = int(max_batch)
        if buckets is None:
            buckets = _pow2_buckets(self.max_batch)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[-1] < self.max_batch or self.buckets[0] < 1:
            raise ValueError(
                f"buckets {self.buckets} must cover max_batch={max_batch}")
        self._sid = spans.new_session()
        self._batch_ids = itertools.count()
        self.stats = SessionStats(session=self._sid)
        # resolve once: input_dtype/input_shape walk the param image
        self._in_torch_dtype = acc.input_dtype
        self._in_dtype = np.dtype(_NUMPY_DTYPES[self._in_torch_dtype])
        self._in_shape = tuple(acc.input_shape)
        # quantized accelerators keep the session float-in/float-out:
        # floats are quantized host-side at staging (so the device batch is
        # int8 end to end) and int8 logits dequantized at drain
        self._quant = acc.quant
        self._single_rank = len(self._in_shape)
        self._max_wait = max(0.0, max_wait_ms) / 1e3
        self._pending: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        # every device operation of the session runs on one stream per
        # device, the current one when it opened: the accelerator's, and
        # the other mesh devices' (a sharded batch's shards)
        self._cuda = self._device.type == "cuda"
        others = (dict.fromkeys(self._mesh.devices.flat)
                  if self._n_devices > 1 else {})
        others.pop(self._device, None)
        # the accelerator's stream entered last (_on_stream), so its device
        # is the current one inside the session's device work
        self._streams = ([torch.cuda.current_stream(d)
                          for d in [*others, self._device]]
                         if self._cuda else [])
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._cuda else None)
        self._device_id = self._device.index if self._cuda else 0

        # -- failure model state --------------------------------------------
        self._deadline_default = (None if deadline_ms is None
                                  else max(0.0, float(deadline_ms)))
        self.queue_limit = queue_limit
        self.on_overload = on_overload
        self._guard_numerics = bool(guard_numerics)
        self._faults = fault_plan
        self._rid_counter = itertools.count()
        self._deadlines = DeadlineTable()
        self._backend_tag = acc.backend
        # pipeline generation: bumped by the watchdog on restart; stale
        # threads check it and stand down without touching shared state
        self._gen = 0
        self._life_lock = threading.Lock()   # serializes restart vs close
        self._closed_done = False
        self._worker_exited_clean = False
        # slot bookkeeping the watchdog uses to free a dead thread's slots:
        # flags only ever flip in the owning thread, and are only read by
        # the watchdog after that thread is confirmed dead/joined
        self._worker_holds_slot = False
        self._drain_popped_unreleased = False
        # the group a pipeline thread is working on, visible so a crash
        # mid-dispatch / mid-deliver cannot strand futures
        self._worker_group: list | None = None
        self._drain_group: list | None = None
        self._thread_exc: BaseException | None = None   # causal, for restart
        self._sup = (ThreadSupervisor(("dispatch", "drain"),
                                      hang_after_s=hang_after_s)
                     if supervise else None)
        self._sup_cv = threading.Condition()
        self._sup_stop = False
        self._sup_thread: threading.Thread | None = None

        # hot path: one cached executor entry per bucket (validated once,
        # lowered or loaded once per bucket), taking the staged input
        # (donate_input). Falls back to acc(x) for segmented / strict
        # accelerators. With an AOT bundle the artifact loads HERE, inside
        # executor_entry -> cache.get: it counts as warm-load time
        self._entries: dict[int, Any] = {}
        self._sharded_entries: dict[int, Any] = {}
        self._params = self._params_sharded = None
        rt = acc.runtime
        if rt is not None and not rt.strict:
            for b in self.buckets:
                t0 = time.monotonic()
                self._entries[b], self._params = rt.executor_entry(
                    b, self._in_torch_dtype, donate_input=True)
                if self._entries[b].aot_loaded:
                    self.stats.warm_load_ms += (time.monotonic() - t0) * 1e3
        # where a batch counts in device_batches: every mesh position for a
        # sharded one, else the first position (or the device's index)
        self._local_ids: tuple = (self._device_id,)
        self._fleet_ids: tuple = self._local_ids
        if self._n_devices > 1:
            if self._params is None:
                raise ValueError(
                    "mesh sharding requires the single-Program cached "
                    "executor path — segmented/strict accelerators can't "
                    "shard over the mesh")
            # sharded entries for every bucket the mesh divides; the
            # stragglers keep the single-device entries. Always lowered in
            # this process (never from an AOT bundle): compile time
            for b in self.buckets:
                if b % self._n_devices == 0:
                    self._sharded_entries[b], self._params_sharded = \
                        rt.executor_entry(b, self._in_torch_dtype,
                                          donate_input=True, mesh=self._mesh)
            if not self._sharded_entries:
                raise ValueError(
                    f"no bucket in {self.buckets} divides evenly over the "
                    f"mesh's {self._n_devices} positions — sharded serving "
                    f"would never engage")
            self._fleet_ids = tuple(range(self._n_devices))
            self._local_ids = (0,)

        # completion pipeline: dispatched-but-unresolved batches, FIFO,
        # bounded by the slot pool (a hard cap: the drainer holds its slot
        # until the batch's logits are on the host)
        self._inflight: deque = deque()
        self._inflight_cv = threading.Condition()
        # serializes staging+dispatch between the worker thread and
        # run_many's inline bulk path
        self._dispatch_mutex = threading.Lock()
        self._slots = slot_pool if slot_pool is not None else _SlotPool(3)
        self._slots.subscribe(self._cv)   # full-pipeline admitters sleep
                                          # on _cv; wake them on slot free

        # staging: a free list of entries per bucket, shared by the worker
        # and run_many's bulk path. An entry is held from staging until its
        # batch's slot is released, so neither the asynchronous host->device
        # copy of its input nor the device->host copy of its logits can race
        # a refill. At most pool-capacity entries of a bucket are held at
        # once: that many are made here (pinned allocations stay off the
        # request path), more only to replace an entry a failure dropped
        self._free_stages: dict[int, list[_Stage]] = {
            b: [self._new_stage(b) for _ in range(self._slots.capacity)]
            for b in self.buckets}
        self._stage_lock = threading.Lock()

        self._warm: set[int] = set()
        if warmup:   # first use of every bucket now, not on a request
            for b in self.buckets:
                t0 = time.monotonic()
                with self._on_stream():
                    y = self._run_bucket(torch.zeros(
                        (b, *self._in_shape), dtype=self._in_torch_dtype,
                        device=self._device))
                    if self._cuda:
                        self._stream.synchronize()
                        for stage in self._free_stages[b]:
                            stage.out = torch.empty(
                                y.shape, dtype=y.dtype, pin_memory=True)
                self._count_first_use(b, t0)

        self._start_pipeline_threads()
        if supervise:
            self._sup_thread = threading.Thread(
                target=self._supervise, daemon=True,
                name="hybriddnn-serving-watchdog")
            self._sup_thread.start()

    def _new_stage(self, bucket: int) -> _Stage:
        with self._on_stream():   # the device buffer lives on this stream
            return _Stage((bucket, *self._in_shape), self._in_torch_dtype,
                          self._device,
                          device_buffer=bucket not in self._entries)

    def _count_first_use(self, bucket: int, t0: float):
        """A bucket's first-use stall counts to ``warm_load_ms`` when its
        entry was loaded from an AOT bundle (nothing was lowered), to
        ``compile_ms`` otherwise (a sharded entry always)."""
        dt = (time.monotonic() - t0) * 1e3
        entry = (None if bucket in self._sharded_entries
                 else self._entries.get(bucket))
        if entry is not None and entry.aot_loaded:
            self.stats.warm_load_ms += dt
        else:
            self.stats.compile_ms += dt
        self._warm.add(bucket)

    def _take_stage(self, bucket: int) -> _Stage:
        """A free staging entry of ``bucket`` for a batch whose slot the
        caller holds (a new one when a failure dropped the free ones)."""
        with self._stage_lock:
            free = self._free_stages[bucket]
            stage = free.pop() if free else None
        if stage is None:
            return self._new_stage(bucket)
        if stage.fence is not None:
            for event in stage.fence:   # its failed batch's copies are done
                event.synchronize()
            stage.fence = None
        return stage

    def _give_stage(self, bucket: int, stage: _Stage, *, settled: bool):
        """Return a batch's entry where its slot is released. ``settled``:
        the batch's event was waited for, so no copy touches the entry any
        more; otherwise fence it behind the work queued so far."""
        if not settled and self._cuda:
            try:
                fence = []
                for stream in self._streams:
                    fence.append(torch.cuda.Event())
                    fence[-1].record(stream)
            except RuntimeError:
                return      # the context is unusable: drop the entry
            stage.fence = fence
        with self._stage_lock:
            self._free_stages[bucket].append(stage)

    def _on_stream(self):
        """The session's streams as the calling thread's current streams."""
        stack = contextlib.ExitStack()
        for stream in self._streams:
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _start_pipeline_threads(self):
        """(Re)start the dispatch + drain pair for the current generation.
        Thread targets take the generation by value: a restarted pipeline
        must never process state a stale thread still thinks it owns."""
        gen = self._gen
        self._worker_exited_clean = False
        self._dispatch_thread = threading.Thread(
            target=self._worker, args=(gen,), daemon=True,
            name=f"hybriddnn-serving-g{gen}")
        self._drain_thread = threading.Thread(
            target=self._drainer, args=(gen,), daemon=True,
            name=f"hybriddnn-serving-drain-g{gen}")
        self._dispatch_thread.start()
        self._drain_thread.start()

    # -- client side --------------------------------------------------------
    def _stage(self, x) -> tuple[np.ndarray, bool]:
        """Validate + host-stage one request (no device work, no locks)."""
        x = to_numpy(x)
        if self._quant is not None and np.issubdtype(x.dtype, np.floating):
            # round-and-clip by the calibrated input scale, the reference's
            # host arithmetic (equal to quant.quantize_input bit for bit):
            # a bare dtype cast would TRUNCATE floats and skip the clip
            x = np.clip(
                np.round(x.astype(np.float32)
                         / np.float32(self._quant.input_scale)),
                -127, 127).astype(self._in_dtype)
        else:
            x = np.asarray(x, self._in_dtype)
        if x.ndim == self._single_rank:
            x, single = x[None], True
        elif x.ndim == self._single_rank + 1:
            single = False
        else:
            raise ValueError(
                f"request rank {x.ndim} does not match input shape "
                f"{self._in_shape} (+ optional batch dim)")
        if not 1 <= x.shape[0] <= self.max_batch:
            raise ValueError(
                f"request batch {x.shape[0]} must be between 1 and "
                f"max_batch={self.max_batch}")
        if tuple(x.shape[1:]) != self._in_shape:
            # reject here, not in the worker: a malformed item would fail
            # the batch assembly and poison every co-batched request
            raise ValueError(
                f"request item shape {tuple(x.shape[1:])} does not match "
                f"the accelerator input shape {self.acc.input_shape}")
        return x, single

    def _make_request(self, x, fut: Future | None, now: float,
                      deadline_ms: float | None) -> _Request:
        """Stage + wrap one request; assigns its session-unique id and
        resolves its absolute deadline. The fault harness's ``staging``
        site fires here, on the caller's thread, against a private copy of
        the staged array."""
        xs, single = self._stage(x)
        rid = next(self._rid_counter)
        if self._faults is not None:
            xs = self._faults.visit(
                "staging", payload=np.array(xs), requests=(rid,),
                rows={rid: (0, xs.shape[0])})
        dl_ms = (self._deadline_default if deadline_ms is None
                 else max(0.0, float(deadline_ms)))
        dl = None if dl_ms is None else now + dl_ms / 1e3
        return _Request(xs, single, fut, now, rid, dl, dl_ms)

    def _queue_full(self) -> bool:
        """Caller holds ``_cv``. Compacts already-resolved (deadline-
        expired/cancelled) entries out of the queue before refusing."""
        if len(self._pending) < self.queue_limit:
            return False
        self._pending = deque(
            r for r in self._pending
            if r.fut is None or not r.fut.done())
        return len(self._pending) >= self.queue_limit

    def _enqueue(self, reqs: list[_Request]):
        """Admission control: bounded queue with shed-or-block overflow,
        deadline registration, exact ``submitted`` accounting."""
        st = self.stats
        notify_sup = False
        with self._cv:
            if self._closed:
                raise RuntimeError("ServingSession is closed")
            for req in reqs:
                if self.queue_limit is not None and self._queue_full():
                    if self.on_overload == "block":
                        while self._queue_full() and not self._closed:
                            self._cv.wait(0.05)
                        if self._closed:
                            raise RuntimeError("ServingSession is closed")
                    else:
                        st.bump("submitted")
                        st.bump("shed")
                        req.fut.set_exception(Overloaded(
                            f"pending queue at queue_limit="
                            f"{self.queue_limit}; request shed"))
                        continue
                st.bump("submitted")
                self._pending.append(req)
                if req.deadline is not None:
                    if self._deadlines.add(req.deadline, req):
                        notify_sup = True
            self._cv.notify()
        if notify_sup and self._sup_thread is not None:
            with self._sup_cv:   # new earliest deadline: shorten the nap
                self._sup_cv.notify_all()

    def submit(self, x, *, deadline_ms: float | None = None) -> Future:
        """Enqueue one request; returns a Future of the result (a single
        item's logits for single-item requests, a batch for batched ones),
        as a float32 numpy array.

        The request is staged host-side (numpy): no device work happens on
        the caller's thread. ``deadline_ms`` overrides the session default
        for this request. With a ``queue_limit`` and a full queue,
        ``on_overload="shed"`` returns a future pre-failed with
        :class:`repro_torch.serving.Overloaded`; ``"block"`` waits."""
        now = time.monotonic()
        req = self._make_request(x, Future(), now, deadline_ms)
        self._enqueue([req])
        return req.fut

    def submit_many(self, xs, *, deadline_ms: float | None = None
                    ) -> list[Future]:
        """Enqueue a whole request list under ONE lock acquisition.
        Validation happens before anything enqueues, so a malformed request
        poisons nothing."""
        now = time.monotonic()
        reqs = [self._make_request(x, Future(), now, deadline_ms)
                for x in xs]
        self._enqueue(reqs)
        return [r.fut for r in reqs]

    def __call__(self, x):
        """Synchronous convenience: submit + wait."""
        return self.submit(x).result()

    def run_many(self, xs) -> list:
        """Run a whole request list; returns results in request order.

        Bulk traffic takes an inline pipelined path: the calling thread
        stages and dispatches full device batches itself (same executor
        entries, same slot pool, same stats), keeping up to the pool's
        capacity in flight and draining oldest-first. Concurrent
        ``submit()`` traffic stays correct (the dispatch mutex serializes
        staging; the shared slot pool keeps device arbitration FIFO-fair),
        it just isn't co-batched with the bulk run."""
        t0 = time.monotonic()
        reqs = [self._make_request(x, None, t0, None) for x in xs]
        if not reqs:
            return []
        with self._cv:
            if self._closed:
                raise RuntimeError("ServingSession is closed")
        self.stats.bump("submitted", len(reqs))
        # cut [start, end) item groups of <= max_batch rows
        groups, start, n = [], 0, 0
        for i, r in enumerate(reqs):
            k = r.x.shape[0]
            if n + k > self.max_batch:
                groups.append((start, i, n))
                start, n = i, 0
            n += k
        groups.append((start, len(reqs), n))
        out: list = [None] * len(reqs)
        errs: list[Exception] = []
        inflight: deque = deque()   # (start, end, y, bucket, stage, bid)

        def _deliver_bulk(s0, outcomes, bid):
            st = self.stats
            done_t = time.monotonic()
            n_ok = 0
            for i, (r, ok, val) in enumerate(outcomes):
                if ok:
                    gexc = self._guard(r, val)
                    if gexc is None:
                        out[s0 + i] = val[0] if r.single else val
                        st.bump("requests")
                        self._answered(r, done_t, bid)
                        n_ok += 1
                        continue
                    st.bump("isolated")
                    val = gexc
                errs.append(val)
                st.bump("errors")
            return n_ok

        def _sync_oldest():
            s0, e0, y, bucket, stage, bid = inflight.popleft()
            group = reqs[s0:e0]
            try:
                if self._faults is not None:
                    self._faults.visit(
                        "drain", requests=[r.rid for r in group])
                y_np = self._to_host(y)          # host sync (+ dequant)
            except Exception as exc:  # noqa: BLE001 — recover per request
                # bisect BEFORE giving the entry back: it must not be
                # refilled until the bisection has re-read it
                try:
                    self._delivered(y, _deliver_bulk(
                        s0, self._bisect(group, bucket, stage.host, exc),
                        bid))
                finally:
                    self._give_stage(bucket, stage, settled=False)
                    self._slots.release()
                return
            self._give_stage(bucket, stage, settled=True)
            self._slots.release()
            self.stats.bump("batches")
            self._delivered(y, _deliver_bulk(
                s0, [(r, True, y_np[r.off:r.off + r.x.shape[0]])
                     for r in group], bid))

        try:
            for s0, e0, n in groups:
                # never wait for a slot while holding one: another bulk
                # caller holding the rest would wait on ours (the reference
                # deadlocks so under concurrent run_many callers)
                acquired = False
                while inflight and not acquired:
                    acquired = self._slots.acquire(blocking=False)
                    if not acquired:
                        _sync_oldest()
                if not acquired:
                    self._slots.acquire()
                group = reqs[s0:e0]
                bucket = stage = None
                bid = next(self._batch_ids)
                try:
                    with self._dispatch_mutex:
                        bucket, stage = self._stage_group(group, n, bid)
                    y = self._launch(bucket, stage, group, bid)
                except Exception as e:  # noqa: BLE001 — recover per request
                    try:
                        if stage is None:
                            raise    # staging failed: nothing to recover
                        _deliver_bulk(
                            s0, self._bisect(group, bucket, stage.host, e),
                            bid)
                    finally:
                        if stage is not None:
                            self._give_stage(bucket, stage, settled=False)
                        self._slots.release()
                    continue
                except BaseException:
                    self._slots.release()
                    raise
                inflight.append((s0, e0, y, bucket, stage, bid))
        finally:
            while inflight:     # release EVERY held slot even on error
                try:
                    _sync_oldest()
                except Exception as e:  # noqa: BLE001 — keep draining
                    errs.append(e)
        if errs:
            self._raise_joined(errs)
        return out

    @staticmethod
    def _raise_joined(errs: list[Exception]):
        """Raise the first error; the rest are attached as notes and
        ``secondary_errors``, and logged — a multi-slot failure must not
        silently swallow every error after the first."""
        first, rest = errs[0], errs[1:]
        for e in rest:
            log.error("serving: additional in-flight batch failure "
                      "(suppressed by %r): %r", first, e)
            first.add_note(f"additionally failed: {e!r}")
        first.secondary_errors = tuple(rest)
        raise first

    def close(self):
        """Drain and shut down. Idempotent, and safe mid-failure: joins are
        bounded, a missing drain sentinel is re-queued, and whatever is
        left queued/in-flight afterwards is failed with
        :class:`repro_torch.serving.PipelineCrashed` and its device slots
        returned to the pool."""
        with self._life_lock:
            if self._closed_done:
                return
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            self._dispatch_thread.join(timeout=60.0)
            if not self._worker_exited_clean:
                # the worker died without queueing the drain sentinel
                # (crashed or stale): queue it so the drainer can exit
                with self._inflight_cv:
                    self._inflight.append(None)
                    self._inflight_cv.notify_all()
            self._drain_thread.join(timeout=60.0)
            exc = PipelineCrashed("ServingSession closed while its "
                                  "pipeline was down")
            exc.__cause__ = self._thread_exc
            self._fail_all_queued(exc)
            self._closed_done = True
        if self._sup_thread is not None:
            with self._sup_cv:
                self._sup_stop = True
                self._sup_cv.notify_all()
            self._sup_thread.join(timeout=10.0)

    def _fail_all_queued(self, exc):
        """Fail every queued + in-flight request and return their pipeline
        slots. Only called with the pipeline threads dead or joined (close
        after join; watchdog after gen retirement)."""
        with self._cv:
            pending = list(self._pending)
            self._pending.clear()
            self._cv.notify_all()
        with self._inflight_cv:
            items = [it for it in self._inflight if it is not None]
            self._inflight.clear()
            self._inflight_cv.notify_all()
        for _ in range(len(items)):
            self._slots.release()
        # a dead thread's locals: its held slot, and the group it popped
        # from the shared deques but never handed off/delivered
        stranded = []
        if not self._dispatch_thread.is_alive():
            if self._worker_holds_slot:
                self._worker_holds_slot = False
                self._slots.release()
            if self._worker_group:
                stranded.extend(self._worker_group)
                self._worker_group = None
        if not self._drain_thread.is_alive():
            if self._drain_popped_unreleased:
                self._drain_popped_unreleased = False
                self._slots.release()
            if self._drain_group:
                stranded.extend(self._drain_group)
                self._drain_group = None
        for it in items:
            for r in it[0]:
                self._reject_req(r, exc)
        for r in stranded:
            self._reject_req(r, exc)
        for r in pending:
            self._reject_req(r, exc)
        return len(items) + (1 if stranded else 0), len(pending)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- dispatch side ------------------------------------------------------
    def _take_group(self, gen: int):
        """Admit pending requests into one device batch (<= max_batch).

        ``"bucketed"``: cut when ``max_wait_ms`` expires, whatever the
        pipeline is doing. ``"continuous"``: the window only caps the wait
        while the device pipeline is IDLE — while any batch is in flight
        the admitter keeps folding arrivals into the open batch until the
        pipeline drains or the batch fills, up to a hard cap of several
        windows (so a co-tenant keeping the shared pool busy never starves
        a straggler). Already-resolved requests are dropped, the hold is
        capped at the earliest deadline in the open batch, and a retired
        generation hands its partial batch back and stands down.

        Spans: ``serving.await`` while the queue is empty, then the
        batch's ``serving.admit`` (rows) and, where the slot pool held no
        batch while the admitter waited, its ``serving.hold``.

        Returns ``(group, n, stale, bid)``, ``bid`` the batch's id.
        """
        continuous = self.scheduler == "continuous"
        sid = self._sid
        with self._cv:
            if not self._pending and not self._closed and self._gen == gen:
                t_await, rng = spans.clock(), spans.enter(spans.AWAIT)
                while (not self._pending and not self._closed
                       and self._gen == gen):
                    self._beat("dispatch")
                    self._cv.wait(0.25)
                spans.close(rng, spans.AWAIT, t_await, session=sid)
            if self._gen != gen:
                return None, 0, True, -1
            if not self._pending:
                return None, 0, False, -1    # closed and drained
            bid = next(self._batch_ids)
            group, n = [], 0
            t_admit, rng_admit = spans.clock(), spans.enter(spans.ADMIT)
            t_hold = rng_hold = None
            deadline = time.monotonic() + self._max_wait
            hard_deadline = deadline + 8 * self._max_wait
            while True:
                while (self._pending
                       and n + self._pending[0].x.shape[0] <= self.max_batch):
                    r = self._pending.popleft()
                    if r.fut is not None and r.fut.done():
                        continue     # expired/cancelled while queued
                    group.append(r)
                    n += r.x.shape[0]
                self._cv.notify_all()    # queue shrank: wake blocked admitters
                if (n >= self.max_batch or self._pending or self._closed
                        or self._gen != gen):
                    break                # full, head won't fit, or draining
                dls = [r.deadline for r in group if r.deadline is not None]
                batch_cap = min(dls) if dls else None
                now = time.monotonic()
                if batch_cap is not None and now >= batch_cap:
                    break                # earliest deadline reached: cut
                busy = self._slots.busy()
                if t_hold is not None and busy:
                    # another caller took a slot: the idle hold ends
                    spans.close(rng_hold, spans.HOLD, t_hold, bid, -1, sid)
                    t_hold = rng_hold = None
                if (continuous and busy and now < hard_deadline
                        and (batch_cap is None or now < batch_cap)):
                    self._cv.wait(0.005)     # device busy: keep admitting
                    continue
                timeout = deadline - now
                if batch_cap is not None:
                    timeout = min(timeout, batch_cap - now)
                if timeout <= 0:
                    break                # batching window expired
                if t_hold is None and not busy:
                    t_hold, rng_hold = spans.clock(), spans.enter(spans.HOLD)
                self._cv.wait(timeout)
            if t_hold is not None:
                spans.close(rng_hold, spans.HOLD, t_hold, bid, -1, sid)
            spans.close(rng_admit, spans.ADMIT, t_admit, bid, -1, sid, n)
            if self._gen != gen:
                # retired mid-take: hand the batch to the new pipeline
                self._pending.extendleft(reversed(group))
                return None, 0, True, -1
            return group, n, False, bid

    def _to_host(self, y) -> np.ndarray:
        """Wait for one launched batch's logits and return them as a host
        array of its own (a copy: the pinned buffer is refilled by the
        entry's next batch); dequantize int8 logits to fp32.

        Dequantization is gated on the ARRAY dtype, not just the session:
        the ``acc(x)`` path of segmented/strict accelerators already
        returns dequantized fp32.

        A launched batch's wait is its ``serving.drain`` span (never a
        profiler range: the card sets it), and while ``spans.on()`` its
        timed events give its ``serving.device`` count."""
        if isinstance(y, _InFlight):
            t0 = spans.clock()
            if y.event is not None:
                y.event.synchronize()      # this batch only, not the stream
            y.t_drained = t1 = spans.clock()
            spans.LOG.record(spans.DRAIN, t0, t1, y.bid, -1, self._sid)
            y.rng = spans.enter(spans.DELIVER)
            if y.ev0 is not None:
                spans.LOG.record(spans.DEVICE, t1, t1, y.bid, -1, self._sid,
                                 round(y.ev0.elapsed_time(y.event) * 1e3))
            y_np = y.out.numpy().copy()
        else:
            y_np = to_numpy(y)
        if self._quant is not None and y_np.dtype == np.int8:
            return (y_np.astype(np.float32)
                    * np.float32(self._quant.output_scale))
        return y_np

    def _delivered(self, y, n_ok: int):
        """End a drained batch's ``serving.deliver`` span, begun where its
        wait ended (``_to_host``)."""
        if isinstance(y, _InFlight) and y.t_drained:
            spans.close(y.rng, spans.DELIVER, y.t_drained, y.bid, -1,
                        self._sid, n_ok)

    def _run_bucket(self, x: torch.Tensor) -> torch.Tensor:
        entry = self._sharded_entries.get(x.shape[0])
        if entry is not None:
            return entry(self._params_sharded, x)
        entry = self._entries.get(x.shape[0])
        if entry is not None:
            return entry(self._params, x)
        return self.acc(x)

    def _stage_group(self, group, n, bid: int):
        """Assemble one device batch into a staging entry — no dispatch;
        its ``serving.stage`` span. The caller holds the batch's slot and
        gives the entry back where it releases that slot.

        Records each request's row offset (``req.off``) so a failed batch
        can be bisected at the same offsets. Returns ``(bucket, stage)``;
        ``_launch`` dispatches it."""
        t0, rng = spans.clock(), spans.enter(spans.STAGE)
        bucket = next(b for b in self.buckets if b >= n)
        stage = self._take_stage(bucket)
        buf = stage.host
        off = 0
        for r in group:
            k = r.x.shape[0]
            buf[off:off + k] = r.x
            r.off = off
            off += k
        if bucket > n:
            buf[n:] = 0
            self.stats.padded_rows += bucket - n
        self.stats.dispatched_rows += n
        for d in (self._fleet_ids if bucket in self._sharded_entries
                  else self._local_ids):
            self.stats.device_batches[d] = \
                self.stats.device_batches.get(d, 0) + 1
        spans.close(rng, spans.STAGE, t0, bid, -1, self._sid, bucket)
        return bucket, stage

    def _launch(self, bucket, stage: _Stage, group, bid: int) -> _InFlight:
        """Launch a staged batch — no host sync. The fault harness's
        ``dispatch`` and ``execute`` sites fire here. On the card: the
        staged input's asynchronous copy into the bucket entry's graph
        input (or, through ``acc(x)``, into the staging entry's device
        buffer), the graph's replay, the logits' asynchronous copy into the
        staging entry's pinned output buffer and an event, all on the
        session's stream, timed as the batch's ``serving.launch`` span;
        the drain thread (or the bulk path) waits on the event."""
        if self._faults is not None:
            rids = [r.rid for r in group]
            self._faults.visit("dispatch", requests=rids)
            self._faults.visit(
                "execute", payload=stage.host, requests=rids,
                rows={r.rid: (r.off, r.x.shape[0]) for r in group},
                backend=self._backend_tag)
        first_use = bucket not in self._warm
        t0 = time.monotonic()
        t_launch, rng = spans.clock(), spans.enter(spans.LAUNCH)
        ev0 = None
        with self._on_stream():
            if self._cuda and spans.on():
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            if stage.dev is None:
                y = self._run_bucket(stage.host_t)
            else:
                stage.dev.copy_(stage.host_t, non_blocking=True)
                y = self.acc(stage.dev)
            if self._cuda:
                if (stage.out is None or stage.out.shape != y.shape
                        or stage.out.dtype != y.dtype):
                    stage.out = torch.empty(y.shape, dtype=y.dtype,
                                            pin_memory=True)
                stage.out.copy_(y, non_blocking=True)
                if y.device != self._device:
                    ev0 = None      # a sharded batch ends on another card
                event = torch.cuda.Event(enable_timing=ev0 is not None)
                event.record(torch.cuda.current_stream(y.device))
                y = _InFlight(stage.out, event, bid, ev0)
            else:
                y = _InFlight(y, None, bid)
        spans.close(rng, spans.LAUNCH, t_launch, bid, -1, self._sid, bucket)
        if first_use:
            self._count_first_use(bucket, t0)
        return y

    # -- failure handling ---------------------------------------------------
    def _beat(self, name: str):
        if self._sup is not None:
            self._sup.beat(name)

    def _guard(self, req: _Request, rows):
        """``guard_numerics``: the NumericsError for non-finite output rows
        of this request, else None."""
        if not self._guard_numerics:
            return None
        rows = np.asarray(rows)
        if (np.issubdtype(rows.dtype, np.floating)
                and not np.all(np.isfinite(rows))):
            return NumericsError(
                f"request {req.rid}: non-finite values in its output rows "
                f"quarantined (guard_numerics=True)")
        return None

    def _reject_req(self, req: _Request, exc: BaseException) -> bool:
        """Resolve ``req`` with ``exc``; True when THIS call resolved it.
        The set_exception winner does the error accounting, so a request
        racing the deadline enforcer against the drain thread is counted
        exactly once."""
        if req.fut is None:
            return False    # bulk path: run_many accounts for it inline
        try:
            req.fut.set_exception(exc)
        except InvalidStateError:
            return False
        st = self.stats
        with st._lock:
            st.errors += 1
            if isinstance(exc, DeadlineExceeded):
                st.deadline_exceeded += 1
        return True

    def _resolve_req(self, req: _Request, rows) -> bool:
        """Resolve ``req`` with its output rows (numerics-guarded); True
        when this call delivered the result."""
        gexc = self._guard(req, rows)
        if gexc is not None:
            if self._reject_req(req, gexc):
                self.stats.bump("isolated")
            return False
        try:
            req.fut.set_result(rows[0] if req.single else rows)
        except InvalidStateError:
            return False    # expired/cancelled first; already accounted
        return True

    def _answered(self, r: _Request, done_t: float, bid: int):
        """Request ``r`` answered at ``done_t``: its ``serving.request``
        span, a child of its batch's."""
        spans.LOG.record(spans.REQUEST, r.t_submit, done_t, r.rid, bid,
                         self._sid, r.x.shape[0])

    def _deliver(self, group, y_np, bid: int):
        """Scatter a drained batch's rows to its futures + count it."""
        done_t = time.monotonic()
        n_ok = 0
        for r in group:
            rows = y_np[r.off:r.off + r.x.shape[0]]
            if self._resolve_req(r, rows):
                n_ok += 1
                self._answered(r, done_t, bid)
        st = self.stats
        st.bump("batches")
        if n_ok:
            st.bump("requests", n_ok)
        return n_ok

    def _deliver_outcomes(self, group, outcomes, bid: int):
        """Resolve per-request recovery outcomes ``(req, ok, rows|exc)``."""
        done_t = time.monotonic()
        n_ok = 0
        for r, ok, val in outcomes:
            if ok:
                if self._resolve_req(r, val):
                    n_ok += 1
                    self._answered(r, done_t, bid)
            else:
                self._reject_req(r, val)
        if n_ok:
            self.stats.bump("requests", n_ok)
        return n_ok

    def _execute_staged(self, bucket, buf, group):
        """Synchronously execute an already-staged host buffer — the
        bisection's retries. Re-visits the fault plan's ``execute`` site so
        request-bound ("cursed") faults keep firing on retry and the
        bisection converges on the offender."""
        if self._faults is not None:
            buf = self._faults.visit(
                "execute", payload=buf, requests=[r.rid for r in group],
                rows={r.rid: (r.off, r.x.shape[0]) for r in group},
                backend=self._backend_tag)
        with self._on_stream():
            x = torch.from_numpy(buf).to(self._device)
            return self._to_host(self._run_bucket(x))

    def _bisect(self, group, bucket, buf, exc):
        """Per-request outcomes for a failed device batch: re-dispatch each
        half **at the same bucket size with the other half's rows zeroed in
        place**, recursing into halves that still fail until the offender
        is alone. Same bucket + same row offsets means the innocent rows
        run through the identical cached executor at identical positions,
        so their results are bit-identical to a fault-free run. Runs on the
        thread that detected the failure while the batch's pipeline slot
        and staging entry are still held (the buffer must survive the
        re-reads).

        Returns ``[(req, ok, rows_or_exc), ...]`` in group order.
        """
        if len(group) == 1:
            self.stats.bump("isolated")
            log.warning("serving: request %d isolated as the batch "
                        "offender: %r", group[0].rid, exc)
            return [(group[0], False, exc)]
        mid = len(group) // 2
        outcomes = []
        for part in (group[:mid], group[mid:]):
            part_buf = np.zeros_like(buf)
            for r in part:
                k = r.x.shape[0]
                part_buf[r.off:r.off + k] = buf[r.off:r.off + k]
            self.stats.bump("retries")
            try:
                y_np = self._execute_staged(bucket, part_buf, part)
            except Exception as e:  # noqa: BLE001 — recurse on the half
                outcomes.extend(self._bisect(part, bucket, part_buf, e))
                continue
            outcomes.extend((r, True, y_np[r.off:r.off + r.x.shape[0]])
                            for r in part)
        return outcomes

    def _worker(self, gen: int):
        """Dispatch loop: batch i+1 is staged and launched while batch i is
        still executing on the device (the drain thread owns completion).

        Crash containment: any escaping exception (including the fault
        harness's ``ThreadKilled``, a BaseException) is recorded as the
        causal ``_thread_exc`` and the thread dies — the supervisor
        detects the dead thread, fails stranded futures and restarts the
        pipeline under a new generation. A retired (stale-generation)
        worker hands unstarted work back to the queue and stands down."""
        try:
            while True:
                group, n, stale, bid = self._take_group(gen)
                if stale:
                    return
                if group is None:
                    with self._inflight_cv:   # closed: wake the drain thread
                        self._inflight.append(None)
                        self._inflight_cv.notify_all()
                    self._worker_exited_clean = True
                    return
                if not group:
                    continue    # every admitted request had already expired
                # the group now lives only in this thread: publish it so the
                # watchdog can fail its futures if we die before handoff
                self._worker_group = group
                self._beat("dispatch")
                # acquire the pipeline slot BEFORE launching, so at most
                # pool-capacity device batches are ever outstanding. The
                # wait is cancellable on generation retirement.
                t_slot, rng = spans.clock(), spans.enter(spans.SLOT)
                got = self._slots.acquire(cancelled=lambda: self._gen != gen)
                spans.close(rng, spans.SLOT, t_slot, bid, -1, self._sid)
                if not got:
                    with self._cv:
                        self._pending.extendleft(reversed(group))
                    self._worker_group = None
                    return
                self._worker_holds_slot = True
                bucket = stage = None
                try:
                    with self._dispatch_mutex:
                        bucket, stage = self._stage_group(group, n, bid)
                    y = self._launch(bucket, stage, group, bid)
                except Exception as e:  # noqa: BLE001 — recover per request
                    try:
                        outcomes = (self._bisect(group, bucket, stage.host, e)
                                    if stage is not None else None)
                    finally:
                        if stage is not None:
                            self._give_stage(bucket, stage, settled=False)
                        self._slots.release()
                        self._worker_holds_slot = False
                    if outcomes is None:    # staging failed: nothing staged
                        self._fail_group(group, e)
                    else:
                        self._deliver_outcomes(group, outcomes, bid)
                    self._worker_group = None
                    continue
                retired = False
                with self._inflight_cv:
                    if self._gen != gen:
                        retired = True    # watchdog owns cleanup now
                    else:
                        self._inflight.append((group, y, bucket, stage, bid))
                        self._worker_holds_slot = False
                        self._worker_group = None
                        self._inflight_cv.notify_all()
                if retired:
                    self._give_stage(bucket, stage, settled=False)
                    self._slots.release()
                    self._worker_holds_slot = False
                    with self._cv:
                        self._pending.extendleft(reversed(group))
                    self._worker_group = None
                    return
        except BaseException as e:  # noqa: BLE001 — watchdog handles it
            self._thread_exc = e
            log.error("serving: dispatch worker died: %r", e)

    # -- completion side ----------------------------------------------------
    def _drainer(self, gen: int):
        """Completion loop: wait for the oldest in-flight batch's logits,
        scatter its rows back to the futures in submission order. The
        batch is PEEKED, drained, and only then released — releasing the
        slot first would let a later batch refill its staging entry while
        its copies may still be running.

        A drain failure triggers per-request recovery (bisection — see
        ``_bisect``) BEFORE the slot and the entry are given back. A
        retired generation abandons its peeked batch untouched: after the
        generation bump the watchdog owns every in-flight item."""
        try:
            while True:
                with self._inflight_cv:
                    while not self._inflight and self._gen == gen:
                        self._beat("drain")
                        self._inflight_cv.wait(0.25)
                    if self._gen != gen:
                        return
                    item = self._inflight[0]     # peek: slot stays occupied
                if item is None:
                    return
                self._beat("drain")
                group, y, bucket, stage, bid = item
                exc = None
                try:
                    if self._faults is not None:
                        self._faults.visit(
                            "drain", requests=[r.rid for r in group])
                    y_np = self._to_host(y)  # the one wait per batch
                                             # (+ dequant for int8 sessions)
                except Exception as e:  # noqa: BLE001 — device error lands here
                    exc = e
                outcomes = (None if exc is None
                            else self._bisect(group, bucket, stage.host,
                                              exc))
                with self._inflight_cv:
                    if self._gen != gen or not self._inflight:
                        return               # retired mid-sync: abandon
                    self._inflight.popleft()     # only this thread pops
                    self._drain_popped_unreleased = True
                    self._drain_group = group    # local-only until delivered
                    self._inflight_cv.notify_all()
                self._give_stage(bucket, stage, settled=exc is None)
                self._slots.release()            # batch done: free the slot
                self._drain_popped_unreleased = False
                if outcomes is not None:
                    n_ok = self._deliver_outcomes(group, outcomes, bid)
                else:
                    n_ok = self._deliver(group, y_np, bid)
                self._delivered(y, n_ok)
                self._drain_group = None
        except BaseException as e:  # noqa: BLE001 — watchdog handles it
            self._thread_exc = e
            log.error("serving: drain thread died: %r", e)

    def _fail_group(self, group, e):
        for r in group:
            self._reject_req(r, e)

    # -- supervision --------------------------------------------------------
    def _supervise(self):
        """Watchdog loop (own thread): enforce request deadlines and watch
        the pipeline threads. Sleeps until the earliest registered
        deadline (or a 50ms poll tick), fails due requests with
        ``DeadlineExceeded``, and restarts the pipeline when a
        dispatch/drain thread is dead — or silent past ``hang_after_s``
        while the session has work."""
        while True:
            with self._sup_cv:
                if self._sup_stop:
                    return
                timeout = 0.05
                nxt = self._deadlines.next_at()
                if nxt is not None:
                    timeout = min(timeout, max(0.001, nxt - time.monotonic()))
                self._sup_cv.wait(timeout)
                if self._sup_stop:
                    return
            now = time.monotonic()
            expired = False
            for req in self._deadlines.pop_due(now):
                if req.fut is not None and not req.fut.done():
                    if self._reject_req(req, DeadlineExceeded(
                            f"request {req.rid} missed its "
                            f"{req.deadline_ms:.1f}ms deadline")):
                        expired = True
            if expired:
                with self._cv:
                    self._cv.notify_all()    # free queue space / admitters
            if self._closed:
                continue    # keep enforcing deadlines until close() stops us
            if self._sup is not None:
                with self._cv:
                    busy = bool(self._pending)
                if not busy:
                    with self._inflight_cv:
                        busy = any(it is not None for it in self._inflight)
                self._sup.update_busy(busy, now=now)
                hung = self._sup.hung(now=now)
            else:
                hung = []
            dead = [name for name, t
                    in (("dispatch", self._dispatch_thread),
                        ("drain", self._drain_thread))
                    if not t.is_alive()]
            if dead or hung:
                self._restart_pipeline(hung)

    def _restart_pipeline(self, hung):
        """Retire the current pipeline generation, fail every queued and
        in-flight future with ``PipelineCrashed`` (causal exception
        chained), return the dead threads' device slots to the pool, and
        start fresh dispatch/drain threads. Serialized against ``close``
        by ``_life_lock``; re-validates liveness under the lock so a
        concurrent clean shutdown is never mistaken for a crash."""
        with self._life_lock:
            if self._closed or self._sup_stop or self._closed_done:
                return
            old = (self._dispatch_thread, self._drain_thread)
            dead = [name for name, t in zip(("dispatch", "drain"), old)
                    if not t.is_alive()]
            if not dead and not hung:
                return
            causal = self._thread_exc
            exc = PipelineCrashed(
                f"pipeline thread(s) {dead or hung} "
                f"{'died' if dead else 'hung'}; the watchdog failed this "
                f"request and restarted the pipeline")
            exc.__cause__ = causal
            with self._cv:
                self._gen += 1           # retire survivors
                self._cv.notify_all()
            with self._inflight_cv:
                self._inflight_cv.notify_all()
            for t in old:
                t.join(timeout=15.0)
            n_inflight, n_pending = self._fail_all_queued(exc)
            self._thread_exc = None
            self.stats.bump("watchdog_restarts")
            log.warning(
                "serving: watchdog restarted the pipeline (gen %d) after "
                "%s %s; failed %d in-flight batch(es) + %d queued "
                "request(s) with PipelineCrashed (causal: %r)",
                self._gen, dead or hung, "died" if dead else "hung",
                n_inflight, n_pending, causal)
            if self._sup is not None:
                self._sup.update_busy(False)     # re-arm hang detection
            self._start_pipeline_threads()


def _session_mesh(mesh, device: torch.device) -> Mesh | None:
    """A session's ``mesh`` argument as a :class:`Mesh` (or ``None``):
    ``"host"`` is every local device of the accelerator's kind
    (``launch.mesh.make_host_mesh``), a sequence of devices a ``("batch",)``
    mesh over them, one position each."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, str) and mesh == "host":
        from repro_torch.launch.mesh import make_host_mesh
        return make_host_mesh(device.type)
    if isinstance(mesh, (list, tuple)):
        return make_mesh((len(mesh),), ("batch",), devices=mesh)
    raise TypeError(f"mesh must be None, 'host', a Mesh or a sequence of "
                    f"devices, got {mesh!r}")


# ---------------------------------------------------------------------------
# Fleet: multi-model tenancy over one process / one device pool
# ---------------------------------------------------------------------------

class Fleet:
    """Several :class:`Accelerator` models served from ONE process over one
    device-slot pool — the paper's NI-instances analog taken to a rack.

    Each model gets its own :class:`ServingSession` (own pending queue, own
    staging buffers, own stats), but every session shares one FIFO-fair
    slot pool, so device time round-robins between tenant models instead
    of one model's burst starving the rest, and one program cache (the
    process-wide ``core.program_cache.default_cache()`` unless the
    accelerators were built against another). ``mesh`` (``None``,
    ``"host"``, a :class:`repro_torch.compat.Mesh` or a sequence of
    devices) is shared by every tenant session: each shards the buckets it
    divides, as a standalone session over the same mesh does.

    ::

        fleet = api.Fleet({"vgg16": acc_vgg, "resnet18": acc_res},
                          mesh="host", max_batch=8)
        fut = fleet.submit("resnet18", x)       # routed to that model
        y = fleet("vgg16", x)                   # submit + wait

    A model's requests run through exactly the cached executor entries
    its standalone session would use: co-tenancy only changes *when* a
    batch gets a device slot, never what it computes.
    """

    def __init__(self, accelerators, *, mesh=None, max_batch: int = 8,
                 buckets: Sequence[int] | None = None,
                 max_wait_ms: float = 5.0, warmup: bool = False,
                 scheduler: str = "continuous", max_inflight: int = 3,
                 deadline_ms: float | None = None,
                 queue_limit: int | None = None,
                 on_overload: str = "shed",
                 guard_numerics: bool = False,
                 fault_plan=None,
                 supervise: bool = True,
                 hang_after_s: float | None = None):
        items = dict(accelerators)
        if not items:
            raise ValueError("Fleet needs at least one named Accelerator")
        mesh = _session_mesh(mesh, next(iter(items.values())).device)
        self.mesh = mesh
        self._pool = _SlotPool(max_inflight)
        self.sessions: dict[str, ServingSession] = {}
        try:
            for name, acc in items.items():
                # the failure model is per-session (own deadlines, queue
                # bound, watchdog) over the SHARED slot pool
                self.sessions[name] = ServingSession(
                    acc, max_batch=max_batch, buckets=buckets, mesh=mesh,
                    max_wait_ms=max_wait_ms, warmup=warmup,
                    scheduler=scheduler, slot_pool=self._pool,
                    deadline_ms=deadline_ms, queue_limit=queue_limit,
                    on_overload=on_overload, guard_numerics=guard_numerics,
                    fault_plan=fault_plan, supervise=supervise,
                    hang_after_s=hang_after_s)
        except BaseException:
            self.close()      # no tenant's threads outlive a failed build
            raise

    @property
    def models(self) -> tuple[str, ...]:
        return tuple(self.sessions)

    def _session(self, model: str) -> ServingSession:
        try:
            return self.sessions[model]
        except KeyError:
            raise ValueError(f"unknown model {model!r}: fleet serves "
                             f"{sorted(self.sessions)}") from None

    def submit(self, model: str, x) -> Future:
        """Enqueue one request for ``model``; returns its Future."""
        return self._session(model).submit(x)

    def __call__(self, model: str, x):
        """Synchronous convenience: submit + wait."""
        return self.submit(model, x).result()

    def run_many(self, requests) -> list:
        """``requests``: iterable of ``(model, x)`` pairs. Every request is
        submitted first — so co-tenant models contend for device slots the
        way live traffic would — then gathered in submission order."""
        pairs = [(m, x) for m, x in requests]
        by_model: dict[str, list] = {}
        for m, x in pairs:
            by_model.setdefault(m, []).append(x)
        futs_by_model = {m: iter(self._session(m).submit_many(xs))
                         for m, xs in by_model.items()}
        futs = [next(futs_by_model[m]) for m, _ in pairs]
        return [f.result() for f in futs]

    def stats(self) -> dict[str, SessionStats]:
        """Per-model :class:`SessionStats`, keyed by model name."""
        return {name: s.stats for name, s in self.sessions.items()}

    def close(self):
        for s in self.sessions.values():
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
