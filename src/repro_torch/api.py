"""``repro_torch.api`` — the user surface of the PyTorch port (Fig. 1 flow).

    from repro_torch import api
    from repro_torch.core import perf_model as pm
    from repro_torch.models import vgg

    specs = vgg.network_specs(224, 1, n_classes=1000)
    acc = api.Accelerator.build(specs, pm.V5E, batch=8, backend="hopper")
    logits = acc(x)                 # cached, validated executor on the card

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
executor is held to.

Not ported yet: the segmented path (it raises ``NotImplementedError``
naming its ROADMAP item), and ``summary``/``save_program``/
``from_program``/``serve`` (ROADMAP Queue 1, items 6 and 8).
"""
from __future__ import annotations

import time
from typing import Any, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.compat import resolve_device, to_tensor
from repro_torch.core import perf_model as pm
from repro_torch.core.compiler import LayerPlan, Program, compile_network
from repro_torch.core.dse import DSEResult
from repro_torch.core.hybrid_conv import (
    ConvSpec,
    DepthwiseSpec,
    FCSpec,
)
from repro_torch.core.runtime import HybridRuntime
from repro_torch.quant import QuantSidecar, calibrate, quantize_params


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


class Accelerator:
    """A built accelerator: DSE verdict + ONE compiled Program + the cached,
    validated executor behind ``__call__``, on one device."""

    def __init__(self, *, specs, plans, params, runtime: HybridRuntime,
                 program: Program, target=None, batch: int = 1,
                 dse: DSEResult | None = None,
                 quant: QuantSidecar | None = None,
                 calib_ms: float | None = None):
        self.specs = list(specs)
        self.plans = list(plans)
        self.params = params
        self.runtime = runtime
        self.program = program
        self.target = target
        self.batch = batch
        self.dse = dse
        self.quant = quant          # QuantSidecar for int8 accelerators
        self.calib_ms = calib_ms    # host time of the int8 calibration

    @property
    def backend(self) -> str:
        return self.runtime.backend

    @property
    def opt_level(self) -> int:
        return self.runtime.opt_level

    @property
    def device(self) -> torch.device:
        return self.runtime.device

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
        """
        if dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported dtype {dtype!r}: expected "
                             f"'float32' or 'int8'")
        if dtype == "int8" and segmented:
            raise ValueError("segmented accelerators are fp32-only — the "
                             "int8 path needs the single-Program runtime "
                             "(the sidecar is keyed to one schedule)")
        if segmented:
            raise NotImplementedError(
                "segmented=True: the legacy multi-Program path is not "
                "ported (ROADMAP Queue 1, item 6); the single-Program path "
                "serves the whole network")
        device = resolve_device(device)
        specs = list(specs)
        dse = None
        if plans is None:
            if not isinstance(target, Target):
                raise TypeError(
                    f"target {target!r} does not implement the Target "
                    f"protocol (needs a run_dse(specs, batch) method) — pass "
                    f"e.g. pm.V5E, pm.VU9P, pm.PYNQ_Z1, or supply plans=")
            # dtype is only passed when quantizing, so custom fp32 targets
            # without the dtype parameter keep working
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
            t0 = time.perf_counter()
            quant = calibrate(specs, params, calib, observer=observer,
                              device=device)
            calib_ms = (time.perf_counter() - t0) * 1e3
            params = quantize_params(specs, params, quant, device=device)

        program = compile_network(specs, plans)
        rt = HybridRuntime(program, backend=backend, opt_level=opt_level,
                           strict=strict, cache=cache, device=device,
                           quant=quant)
        rt.load_params(params)
        if not strict:
            rt.cache.validate(program)  # schedule check once, at build time
        return cls(specs=specs, plans=plans, params=params, runtime=rt,
                   program=program, target=target, batch=batch, dse=dse,
                   quant=quant, calib_ms=calib_ms)

    # -- inference ----------------------------------------------------------
    def __call__(self, x) -> torch.Tensor:
        """One inference request. ``x``: (n, H, W, C) for CONV-first models,
        (n, D) for FC-first, as an array or tensor; runs on the
        accelerator's device. Quantized accelerators are float-in/float-out:
        float inputs are quantized at the calibrated input scale (int8
        inputs pass through) and the int8 logits are dequantized."""
        if self.quant is not None:
            y = self.runtime.run(to_tensor(x, self.device))
            return self.quant.dequantize_output(y)
        return self.runtime.run(to_tensor(x, self.device, torch.float32))

    @property
    def input_dtype(self) -> torch.dtype:
        """The stored weight type: float32, or int8 when quantized."""
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
        return len(self.program.instructions)

    def strict_request(self):
        """A per-instruction-interpreter request fn over the same Program
        and params, on this accelerator's device: the hazard-faithful
        baseline for comparisons. It always runs the ``torch`` PE, whatever
        this accelerator's ``backend``, so it is the oracle for the
        ``hopper`` path too. A quantized accelerator's interpreter carries
        the same sidecar, so its int8 outputs compare bit for bit with the
        raw executor's (``runtime.run``)."""
        rt = HybridRuntime(self.program, strict=True, device=self.device,
                           quant=self.quant)
        rt.load_params(self.params)
        return rt.run
