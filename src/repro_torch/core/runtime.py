"""Light-weight runtime: executes a HybridDNN instruction stream (Sec. 3 (4)).

Two execution paths share one hazard contract:

* ``strict=True`` — the functional interpreter of the 128-bit ISA. It
  models the accelerator's on-chip state — ping-pong input/weight buffers,
  a bias buffer and the per-layer output staging — and enforces the
  handshake-FIFO discipline of Sec. 4.1 *per instruction*: COMP, POOL, FC,
  ELTWISE_ADD and DEPTHWISE_CONV check that the slots they address hold the
  (layer, group) data their operands need, and SAVE that every block it
  flushes was produced. A mis-scheduled stream raises ``HazardError``
  instead of computing garbage. The hazard checks compare slot tags, never
  tensor data, so every tensor stays on the runtime's device.

* default — the **validate-once, run-many** path (``core/executor.py``):
  the same discipline runs once per ``Program`` as a symbolic
  schedule-validation pass, then the lowered ``execute(params, x)`` —
  cached per full key in ``core/program_cache.py`` — does the math as a
  static dataflow.

Both paths walk the stream with the executor's ``ScheduleWalk`` (one copy
of the tag checks, their ``HazardError`` messages and the ``stats``
counters; the interpreter supplies the data through its hooks) and compute
with the executor's per-block PE helpers (``conv_block_forward``,
``fc_forward``, ``pool_forward``, ``eltwise_forward``,
``depthwise_forward``, ``slice_input_rows``), so the ``backend`` knob
routes the interpreter and the executor through the same PE, and the
interpreter equals the ``opt_level=0`` executor bit for bit.

DRAM is a word-addressed store (dict base-address -> tensor). Winograd-mode
weights live in DRAM pre-transformed to U-space (Sec. 4.2.3), so LOAD_WGT
traffic matches Eq. 9. The SAVE stage applies the layout reorder for the
next layer's mode (Sec. 4.3) once the layer's last block lands.

``quant`` (a :class:`repro_torch.quant.QuantSidecar`) makes the runtime an
int8 one on both paths: the DRAM image holds int8 weights and int32 biases,
a float input is quantized at the sidecar's input scale (an int8 input
passes through), and the output is the network's int8 logits.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.compat import resolve_backend, resolve_device, to_tensor
from repro_torch.core import layouts
from repro_torch.core.compiler import CompiledLayer, Program
from repro_torch.core.executor import (  # noqa: F401  (HazardError re-export)
    HazardError,
    ScheduleWalk,
    _fresh_stats,
    check_lowerable,
    check_param_count,
    conv_block_forward,
    depthwise_forward,
    eltwise_forward,
    fc_forward,
    mesh_device_count,
    pool_forward,
    resolve_opt_level,
    slice_input_rows,
)
from repro_torch.core.isa import Opcode
from repro_torch.core.winograd import transform_weights


class HybridRuntime:
    """Executes a compiled :class:`~repro_torch.core.compiler.Program`
    against DRAM-resident params and input.

    ``backend`` picks the PE for CONV/FC blocks (``"torch"`` or
    ``"hopper"``) on both paths, ``opt_level`` the lowering optimizer of the
    cached executor (1 fuses where provably equivalent, 0 keeps the literal
    per-block lowering; the interpreter is per-instruction and ignores it),
    ``strict=True`` the per-instruction interpreter instead of the cached
    executor, ``cache`` overrides the process-wide program cache, and
    ``device`` is where the DRAM image and the requests live (``None`` =
    CUDA, raising when it is absent), and ``quant`` switches every
    parameterized block to the int8 PE (params must then be the quantized
    image, ``quant.quantize_params``; the sidecar's digest joins the
    program-cache key). ``aot_dir`` names an AOT bundle's artifact
    directory (``core/aot.py``): executor entries load from it on a cache
    miss when their key matches.
    """

    def __init__(self, program: Program, *, backend: str = "torch",
                 opt_level: int = 1, strict: bool = False, cache=None,
                 device=None, quant=None, aot_dir: str | None = None):
        self.program = program
        self.backend = resolve_backend(backend)
        self.opt_level = resolve_opt_level(opt_level)
        self.strict = strict
        self.device = resolve_device(device)
        self.quant = quant
        self.aot_dir = aot_dir
        self._cache = cache
        self.dram: dict[int, Any] = {}
        self._replicas: dict[str, list] = {}   # device -> its weight copy
        self._loaded = False
        # pipeline statistics — the same counter keys as the executor's
        # schedule-validation pass; the interpreter adds to them per run
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
        (CONV, FC and DEPTHWISE, in network order; POOL and ELTWISE layers
        carry none), as tensors or arrays; integer types stay as they are
        (int8 weights, int32 biases). Winograd CONV layers store U-space
        weights."""
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
        self._replicas.clear()
        self._loaded = True

    def dram_params(self) -> list[tuple[Any, Any]]:
        """The DRAM weight image ``load_params`` built — U-space for Winograd
        CONV layers, raw for Spatial/FC/DEPTHWISE; one entry per
        parameterized layer."""
        if not self._loaded:
            raise RuntimeError("load_params must be called first")
        return [(self.dram[cl.wgt_addr], self.dram[cl.bias_addr])
                for cl in self.program.layers
                if cl.kind not in ("pool", "eltwise")]

    def executor_entry(self, batch: int, dtype=torch.float32, *,
                       donate_input: bool = False, mesh=None):
        """The cached executor + DRAM weight image for (batch, dtype).
        Schedule validation runs once per schedule key (cached).

        The serving hot path: a caller holding a fixed parameter set (the
        ``ServingSession``) invokes ``entry(params, x)`` directly.
        ``donate_input=True`` asks for the entry whose caller hands its
        input buffer over until the batch completes (the session's pinned
        staging, copied straight into the entry's CUDA graph); the direct
        ``run`` path keeps ``False``. ``mesh`` (more than one position)
        asks for the sharded entry; the params then come as one weight
        image per position (:meth:`replicated_params`)."""
        if self.strict:
            raise RuntimeError(
                "strict interpreter mode has no cached executor entry")
        params = self.dram_params()
        self.stats = self.cache.validate(self.program)
        entry = self.cache.get(
            self.program, batch=batch, dtype=dtype,
            param_dtypes=tuple(str(w.dtype) for w, _ in params),
            backend=self.backend, opt_level=self.opt_level,
            donate_input=donate_input, device=self.device, mesh=mesh,
            quant=self.quant, aot_dir=self.aot_dir)
        if mesh_device_count(mesh) > 1:
            params = self.replicated_params(mesh)
        return entry, params

    def replicated_params(self, mesh) -> list:
        """The DRAM weight image once per position of ``mesh``: positions
        on the runtime's device share its image, and every other device
        gets one copy, made at its first request and kept (positions that
        repeat a device share it)."""
        params = self.dram_params()
        out = []
        for d in mesh.devices.flat:
            if d == self.device:
                out.append(params)
                continue
            rep = self._replicas.get(str(d))
            if rep is None:
                rep = self._replicas[str(d)] = [
                    (w.to(d), b.to(d)) for w, b in params]
            out.append(rep)
        return out

    def export_aot(self, aot_dir: str, x_shape, dtype, *,
                   donate_input: bool = False) -> str:
        """Export the executor for input shape ``x_shape`` (batch leading)
        into ``aot_dir``, keyed by the full program-cache key plus the
        environment fingerprint (``core/aot.py``); returns the artifact
        digest. The export traces fake tensors: no device math runs."""
        from repro_torch.core import aot
        from repro_torch.core.executor import compile_executor
        from repro_torch.core.program_cache import cache_key

        batch = int(x_shape[0])
        entry, params = self.executor_entry(batch, dtype,
                                            donate_input=donate_input)
        if entry.aot_loaded:
            # a loaded program holds no lowered function to trace: lower
            # one, so re-exporting a warm-loaded runtime still works
            entry = compile_executor(
                self.program, stats=self.stats, backend=self.backend,
                opt_level=self.opt_level, donate_input=donate_input,
                device=self.device, quant=self.quant)
        key = cache_key(
            self.program, batch=batch, dtype=dtype,
            param_dtypes=tuple(str(w.dtype) for w, _ in params),
            backend=self.backend, opt_level=self.opt_level,
            donate_input=donate_input, device=self.device, quant=self.quant)
        return aot.save_entry(aot_dir, entry, params, tuple(x_shape), dtype,
                              key)

    def write_input(self, x_nhwc: torch.Tensor):
        cl0 = self.program.layers[0]
        if cl0.inp_layout == "wino":
            x_nhwc = layouts.save_transform(x_nhwc, "wino", cl0.plan.m)
        self.dram[cl0.inp_addr] = x_nhwc

    # -- execution ----------------------------------------------------------
    def run(self, x_nhwc: torch.Tensor | None = None) -> torch.Tensor:
        """Execute the program; returns the last layer's output.
        ``x_nhwc`` defaults to the input already in DRAM.

        Default: schedule validation (cached) + the cached executor.
        ``strict=True``: the per-instruction interpreter."""
        if not self._loaded:
            raise RuntimeError("load_params must be called before run()")
        if x_nhwc is not None:
            x_nhwc = self._maybe_quantize_input(to_tensor(x_nhwc,
                                                          self.device))
            self.write_input(x_nhwc)       # same DRAM contract on both paths
        if self.strict:
            with torch.no_grad():
                return self._run_interpreter()
        if x_nhwc is None:
            cl0 = self.program.layers[0]
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

    def _run_interpreter(self) -> torch.Tensor:
        _Interpreter(self).walk(self.program, self.stats)
        return self.dram[self.program.layers[-1].out_addr]

    # -- helpers ------------------------------------------------------------
    def _load_input_group(self, cl: CompiledLayer, ih: int) -> torch.Tensor:
        """The input rows (plus halo) output row group ``ih`` needs, through
        the executor's helper: one copy of the halo arithmetic."""
        x = layouts.load_view(self.dram[cl.inp_addr], cl.inp_layout,
                              hw=(cl.spec.h, cl.spec.w))
        return slice_input_rows(cl, x, ih)

    def _layer_quant(self, cl: CompiledLayer):
        return (self.quant.layers[cl.layer_id] if self.quant is not None
                else None)


class _Interpreter(ScheduleWalk):
    """The executor's hazard walk (:class:`ScheduleWalk`) with data: LOADs
    read the runtime's DRAM into the slots, each compute opcode runs its
    per-block PE helper on its slots' data, SAVE writes the blocks into the
    layer's output staging, and the layer's end stores the staging to DRAM
    in the next layer's layout."""

    def __init__(self, rt: HybridRuntime):
        self.rt = rt
        self.staging = None      # NHWC assembly of the current layer's output

    def load(self, cl, ins, group):
        data = self.rt.dram[ins.dram_base]
        if ins.opcode == Opcode.LOAD_WGT:
            lo, hi = cl.k_groups[group]
            # contiguous, as the executor slices it: the same PE calls
            return data[..., lo:hi].contiguous()
        if ins.opcode == Opcode.LOAD_INP and cl.kind == "conv":
            return self.rt._load_input_group(cl, group)
        # the bias, or an identity load of the stored tensor (the forward
        # helpers apply the layout view themselves); ELTWISE reads two
        # operands, each by the DRAM base its own LOAD_INP names
        return data

    def comp(self, cl, ins, x, w, bias, ih, kg):
        lo, hi = cl.k_groups[kg]
        blk = conv_block_forward(
            cl, x, w, bias[lo:hi], ins.relu_flag, backend=self.rt.backend,
            quant=self.rt._layer_quant(cl), k_range=(lo, hi))
        r0, r1 = cl.row_groups[ih]
        return blk[:, :r1 - r0]

    def pool(self, cl, ins, x):
        return pool_forward(cl, x, ins.pool_window, ins.pool_stride)

    def fc(self, cl, ins, x, w, bias):
        return fc_forward(cl, w, bias, x, ins.relu_flag,
                          backend=self.rt.backend,
                          quant=self.rt._layer_quant(cl))

    def eltwise(self, cl, ins, x, skip):
        return eltwise_forward(cl, x, skip, ins.relu_flag,
                               quant=self.rt._layer_quant(cl))

    def depthwise(self, cl, ins, x, w, bias):
        return depthwise_forward(cl, w, bias, x, ins.relu_flag,
                                 quant=self.rt._layer_quant(cl))

    def save(self, cl, ins, blocks):
        if cl.kind != "conv":
            self.staging = blocks[0]
            return
        ih = ins.size & 0xFFF
        kg = (ins.size >> 12) & 0xFFF
        if self.staging is None:
            src = self.rt.dram[cl.inp_addr]
            ho, wo = cl.spec.out_hw
            self.staging = torch.zeros((src.shape[0], ho, wo, cl.spec.k),
                                       dtype=src.dtype, device=self.rt.device)
        r0, r1 = cl.row_groups[ih]
        if cl.plan.dataflow == "is":
            # one SAVE per row group: its K groups side by side
            self.staging[:, r0:r1] = (blocks[0] if len(blocks) == 1
                                      else torch.cat(blocks, dim=-1))
        else:
            c0, c1 = cl.k_groups[kg]
            self.staging[:, r0:r1, :, c0:c1] = blocks[0]

    def flush(self, cl):
        staging, self.staging = self.staging, None
        if cl.out_layout == "wino":
            staging = layouts.save_transform(staging, "wino", cl.out_m)
        self.rt.dram[cl.out_addr] = staging


def run_program(program: Program, params, x_nhwc, **kw) -> torch.Tensor:
    rt = HybridRuntime(program, **kw)
    rt.load_params(params)
    return rt.run(x_nhwc)
