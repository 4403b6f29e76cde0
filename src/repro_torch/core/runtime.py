"""Light-weight runtime: executes a HybridDNN instruction stream (Sec. 3 (4)).

The **validate-once, run-many** path (``core/executor.py``): the hazard
discipline runs once per ``Program`` as a symbolic schedule-validation pass
(``HazardError`` on a bad stream, plus the ``stats`` counters), then the
lowered ``execute(params, x)`` — cached per full key in
``core/program_cache.py`` — does the math as a static dataflow.

DRAM is a word-addressed store (dict base-address -> tensor). Winograd-mode
weights live in DRAM pre-transformed to U-space (Sec. 4.2.3), so LOAD_WGT
traffic matches Eq. 9.

``quant`` (a :class:`repro_torch.quant.QuantSidecar`) makes the runtime an
int8 one: the DRAM image holds int8 weights and int32 biases, a float input
is quantized at the sidecar's input scale (an int8 input passes through),
and the output is the network's int8 logits.

The reference's per-instruction interpreter (``strict=True``) is not ported
yet: it raises ``NotImplementedError`` (ROADMAP Queue 1, item 4).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.compat import resolve_backend, resolve_device, to_tensor
from repro_torch.core import layouts
from repro_torch.core.compiler import Program
from repro_torch.core.executor import (  # noqa: F401  (HazardError re-export)
    HazardError,
    _fresh_stats,
    check_lowerable,
    check_param_count,
    resolve_opt_level,
)
from repro_torch.core.winograd import transform_weights

STRICT_NOT_PORTED = ("the strict per-instruction interpreter is not ported "
                     "yet (ROADMAP Queue 1, item 4: core/runtime.py strict "
                     "HybridRuntime)")


class HybridRuntime:
    """Executes a compiled :class:`~repro_torch.core.compiler.Program`
    against DRAM-resident params and input.

    ``backend`` picks the PE for CONV/FC blocks (``"torch"`` or
    ``"hopper"``), ``opt_level`` the lowering optimizer (1 fuses where
    provably equivalent, 0 keeps the literal per-block lowering), ``cache``
    overrides the process-wide program cache, and ``device`` is where the
    DRAM image and the requests live (``None`` = CUDA, raising when it is
    absent), and ``quant`` switches every parameterized block to the int8 PE
    (params must then be the quantized image, ``quant.quantize_params``;
    the sidecar's digest joins the program-cache key).
    """

    def __init__(self, program: Program, *, backend: str = "torch",
                 opt_level: int = 1, strict: bool = False, cache=None,
                 device=None, quant=None):
        if strict:
            raise NotImplementedError(STRICT_NOT_PORTED)
        self.program = program
        self.backend = resolve_backend(backend)
        self.opt_level = resolve_opt_level(opt_level)
        self.device = resolve_device(device)
        self.quant = quant
        self._cache = cache
        self.dram: dict[int, Any] = {}
        self._loaded = False
        self.stats = _fresh_stats()

    @property
    def cache(self):
        if self._cache is None:
            from repro_torch.core.program_cache import default_cache
            self._cache = default_cache()
        return self._cache

    # -- DRAM management ----------------------------------------------------
    def load_params(self, params: list[tuple[Any, Any]]):
        """params: [(w, bias), ...] — one entry per *parameterized* layer
        (CONV and FC, in network order; POOL and ELTWISE layers carry none),
        as tensors or arrays; integer types stay as they are (int8 weights,
        int32 biases). Winograd CONV layers store U-space weights."""
        check_param_count(self.program, params)
        check_lowerable(self.program)
        it = iter(params)
        for cl in self.program.layers:
            if cl.kind in ("pool", "eltwise"):
                continue
            w, b = (to_tensor(a, self.device) for a in next(it))
            if cl.kind == "conv" and cl.plan.mode == "wino":
                w = transform_weights(w, cl.plan.m)
            self.dram[cl.wgt_addr] = w.contiguous()
            self.dram[cl.bias_addr] = b.contiguous()
        self._loaded = True

    def dram_params(self) -> list[tuple[Any, Any]]:
        """The DRAM weight image ``load_params`` built — U-space for Winograd
        CONV layers, raw for Spatial/FC; one entry per parameterized layer."""
        if not self._loaded:
            raise RuntimeError("load_params must be called first")
        return [(self.dram[cl.wgt_addr], self.dram[cl.bias_addr])
                for cl in self.program.layers
                if cl.kind not in ("pool", "eltwise")]

    def executor_entry(self, batch: int, dtype=torch.float32):
        """The cached executor + DRAM weight image for (batch, dtype).
        Schedule validation runs once per schedule key (cached)."""
        params = self.dram_params()
        self.stats = self.cache.validate(self.program)
        entry = self.cache.get(
            self.program, batch=batch, dtype=dtype,
            param_dtypes=tuple(str(w.dtype) for w, _ in params),
            backend=self.backend, opt_level=self.opt_level,
            device=self.device, quant=self.quant)
        return entry, params

    def write_input(self, x_nhwc: torch.Tensor):
        cl0 = self.program.layers[0]
        if cl0.inp_layout == "wino":
            x_nhwc = layouts.save_transform(x_nhwc, "wino", cl0.plan.m)
        self.dram[cl0.inp_addr] = x_nhwc

    # -- execution ----------------------------------------------------------
    def run(self, x_nhwc: torch.Tensor | None = None) -> torch.Tensor:
        """Validate (cached) + execute the program; returns the last
        layer's output. ``x_nhwc`` defaults to the input already in DRAM."""
        if not self._loaded:
            raise RuntimeError("load_params must be called before run()")
        cl0 = self.program.layers[0]
        if x_nhwc is not None:
            x_nhwc = self._maybe_quantize_input(to_tensor(x_nhwc,
                                                          self.device))
            self.write_input(x_nhwc)       # same DRAM contract as the device
        else:
            stored = self.dram[cl0.inp_addr]
            if cl0.kind == "fc":           # FC-first: flat activation, no hw
                x_nhwc = stored.reshape(stored.shape[0], -1)
            else:
                x_nhwc = layouts.load_view(stored, cl0.inp_layout,
                                           hw=(cl0.spec.h, cl0.spec.w))
        entry, params = self.executor_entry(x_nhwc.shape[0], x_nhwc.dtype)
        y = entry(params, x_nhwc)
        self.dram[self.program.layers[-1].out_addr] = y
        return y

    def _maybe_quantize_input(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """Quantized runtimes accept float inputs: quantize them at the
        sidecar's input scale (an int8 input passes through unchanged)."""
        if self.quant is not None and x_nhwc.dtype.is_floating_point:
            return self.quant.quantize_input(x_nhwc)
        return x_nhwc
