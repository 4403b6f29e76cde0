"""Two-phase program execution: validate once, run many.

* **Phase 1 — schedule validation** (:func:`validate_schedule`): replay the
  instruction stream against *symbolic* buffer state only (slot tags, block
  sets — no tensors). This enforces the handshake-FIFO discipline of
  Sec. 4.1 — LOAD over a live slot, COMP before its LOADs, SAVE before
  COMP, a missing final SAVE all raise :class:`HazardError` — and produces
  the pipeline-statistics counters. It runs once per ``Program``. Ported
  whole from the reference: every opcode validates, ELTWISE_ADD and
  DEPTHWISE_CONV included. The walk (:class:`ScheduleWalk`) is the strict
  interpreter's too, which supplies the data through its hooks.

* **Phase 2 — lowering** (:func:`lower_program`): turn the validated
  schedule into a function ``execute(params, x) -> y`` of tensor ops with
  static Python control flow — per-layer blocked compute (the same
  row-group/k-group blocks the COMP instructions name), assembled with
  ``torch.cat``. PyTorch runs eagerly, so there is no trace: the function
  is built once per cache entry and called per request.

Backends: lowering emits each block's compute through one of two PE
implementations, selected by ``backend=``:

* ``"torch"`` — plain aten ops on any device (the reference's ``"xla"``).
* ``"hopper"`` — the hand-written CUDA kernels (the reference's
  ``"pallas"``): K1 for Spatial CONV, K3 + K2 + K4 for Winograd CONV, K2
  for FC. On CPU tensors each kernel runs its plain PyTorch version.

POOL, ELTWISE_ADD and DEPTHWISE_CONV blocks lower through plain aten ops
on both backends: pooling is comparisons, the residual add and the
per-channel depthwise conv are element-parallel, not PE MACs.

The per-block helpers (:func:`conv_block_forward`, :func:`fc_forward`,
:func:`pool_forward`, :func:`eltwise_forward`, :func:`depthwise_forward`,
:func:`slice_input_rows`) are shared with the strict interpreter
(``core/runtime.py``), so the two paths cannot drift.

``quant`` (a :class:`repro_torch.quant.QuantSidecar`) lowers every
parameterized block through the int8 PE instead (``quant/execute.py``:
K5 on ``"hopper"``, an exact float64 product on ``"torch"``; the depthwise
conv through ``qdepthwise`` on both), and the residual add through
``qeltwise``; the schedule, blocking and liveness walk are untouched.

Lowering optimizer (``opt_level``): ``opt_level=1`` runs
:func:`analyze_program` first. A CONV layer whose blocks are provably
equivalent to one whole-layer dispatch — every COMP block carries the same
RELU bit, the k-groups contiguously tile [0, K), the row groups contiguously
tile the output height — collapses to a single PE call over the full weight
image. A layer whose RELU bits differ between blocks cannot fuse; on the
torch backend with equal-sized k-groups it lowers to the stacked form (one
PE call without ReLU plus a static per-block ReLU mask), and anything else —
including every mixed-RELU layer on the hopper backend — keeps the literal
blocked lowering. ``opt_level=0`` keeps the literal lowering everywhere.
The verdicts equal the reference's for the matching backend.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable

import torch

from repro_torch import spans
from repro_torch.compat import resolve_backend
from repro_torch.core import layouts
from repro_torch.core import winograd as wino
from repro_torch.core.compiler import CompiledLayer, Program
from repro_torch.core.hybrid_conv import (
    dense,
    depthwise_conv2d,
    hybrid_conv2d,
    max_pool2d,
    same_pad,
)
from repro_torch.core.isa import Opcode, unpack_dw_geom, unpack_fc_dims
from repro_torch.kernels.common import (
    add_launches,
    holding_constants,
    recording_launches,
)
from repro_torch.core.winograd import (
    transform_weights,
    winograd_apply_pretransformed,
)
from repro_torch.quant.execute import (
    layer_multiplier,
    qconv2d,
    qdense,
    qdepthwise,
    qeltwise,
)
from repro_torch.quant.sidecar import LayerQuant, QuantSidecar


class HazardError(RuntimeError):
    """Instruction-stream hazard: the handshake FIFO discipline was violated."""


OPT_LEVELS = (0, 1)


def resolve_opt_level(opt_level: int) -> int:
    """Validate the lowering-optimizer level (0 = literal per-block
    lowering, 1 = fused whole-layer lowering where provably equivalent)."""
    if opt_level not in OPT_LEVELS:
        raise ValueError(
            f"unknown opt_level {opt_level!r}: expected one of {OPT_LEVELS}")
    return int(opt_level)


def _fresh_stats() -> dict[str, int]:
    return {"load_inp": 0, "load_wgt": 0, "load_bias": 0,
            "comp": 0, "pool": 0, "fc": 0, "eltwise": 0, "dw": 0,
            "save": 0, "inp_words": 0, "wgt_words": 0}


# ---------------------------------------------------------------------------
# Phase 1: schedule validation (symbolic replay, no tensors)
# ---------------------------------------------------------------------------

class ScheduleWalk:
    """One replay of an instruction stream under the handshake-FIFO
    discipline of Sec. 4.1: ping-pong input and weight slots and a bias
    buffer, each tagged with the (layer, group) it holds, and the blocks the
    current layer has computed but not yet saved. :meth:`walk` raises
    :class:`HazardError` at the first instruction that breaks it and adds
    to ``stats`` per instruction.

    The hooks supply the data: what a LOAD puts in its slot, the block a
    compute opcode makes from its slots' data, and what SAVE and the end of
    a layer do with the blocks. Here they carry none: the symbolic pass of
    :func:`validate_schedule`. The strict interpreter (``core/runtime.py``)
    overrides them with DRAM reads and the per-block PE helpers, so the two
    share one hazard contract.
    """

    def load(self, cl: CompiledLayer, ins, group: int):
        """LOAD_BIAS, LOAD_INP (row group ``group``) or LOAD_WGT (k-group
        ``group``): the slot's data."""
        return None

    def comp(self, cl, ins, x, w, bias, ih: int, kg: int):
        return None

    def pool(self, cl, ins, x):
        return None

    def fc(self, cl, ins, x, w, bias):
        return None

    def eltwise(self, cl, ins, x, skip):
        return None

    def depthwise(self, cl, ins, x, w, bias):
        return None

    def save(self, cl, ins, blocks: list) -> None:
        """SAVE of ``blocks`` (all of a row group's k-groups under IS
        dataflow, one block otherwise)."""

    def flush(self, cl) -> None:
        """The end of layer ``cl``, every block of it saved."""

    def walk(self, program: Program, stats: dict[str, int]) -> None:
        inp: list[tuple] = [(None, None), (None, None)]   # (tag, data)
        wgt: list[tuple] = [(None, None), (None, None)]
        bias: tuple = (None, None)
        blocks: dict[tuple[int, int], object] = {}
        saved = False
        cur_layer = -1

        for ins in program.instructions:
            cl = program.layers[ins.layer_id]
            lid = ins.layer_id
            if lid != cur_layer:
                if cur_layer >= 0:
                    self._end_layer(program.layers[cur_layer], blocks, saved)
                cur_layer = lid
                blocks = {}
                saved = False

            op = ins.opcode
            if op == Opcode.LOAD_BIAS:
                bias = ((lid,), self.load(cl, ins, 0))
                stats["load_bias"] += 1
            elif op == Opcode.LOAD_INP:
                ih, slot = ins.buff_base >> 1, ins.buff_base & 1
                inp[slot] = ((lid, ih), self.load(cl, ins, ih))
                stats["load_inp"] += 1
                stats["inp_words"] += ins.size
            elif op == Opcode.LOAD_WGT:
                kg, slot = ins.buff_base >> 1, ins.buff_base & 1
                wgt[slot] = ((lid, kg), self.load(cl, ins, kg))
                stats["load_wgt"] += 1
                stats["wgt_words"] += ins.size
            elif op == Opcode.COMP:
                ih = ins.size & 0xFFF
                kg = (ins.size >> 12) & 0xFFF
                islot = (ins.size >> 24) & 1
                wslot = (ins.size >> 25) & 1
                if inp[islot][0] != (lid, ih):
                    raise HazardError(
                        f"COMP L{lid} row-group {ih}: input slot "
                        f"{islot} holds {inp[islot][0]}")
                if wgt[wslot][0] != (lid, kg):
                    raise HazardError(
                        f"COMP L{lid} k-group {kg}: weight slot "
                        f"{wslot} holds {wgt[wslot][0]}")
                if bias[0] != (lid,):
                    raise HazardError(f"COMP L{lid}: stale bias buffer")
                blocks[(ih, kg)] = self.comp(cl, ins, inp[islot][1],
                                             wgt[wslot][1], bias[1], ih, kg)
                stats["comp"] += 1
            elif op == Opcode.POOL:
                islot = ins.buff_base & 1
                cfg = (ins.pool_window, ins.pool_stride)
                if cfg != (cl.spec.window, cl.spec.stride):
                    raise HazardError(
                        f"POOL L{lid}: word0 window/stride {cfg} "
                        f"disagree with compiled spec "
                        f"({cl.spec.window}, {cl.spec.stride})")
                if inp[islot][0] != (lid, 0):
                    raise HazardError(
                        f"POOL L{lid}: input slot {islot} holds "
                        f"{inp[islot][0]}")
                blocks[(0, 0)] = self.pool(cl, ins, inp[islot][1])
                stats["pool"] += 1
            elif op == Opcode.FC:
                islot = ins.buff_base & 1
                wslot = (ins.buff_base >> 1) & 1
                dims = unpack_fc_dims(ins.size)
                if dims != (cl.spec.d_in, cl.spec.d_out):
                    raise HazardError(
                        f"FC L{lid}: word3 dims {dims} disagree with "
                        f"compiled spec ({cl.spec.d_in}, {cl.spec.d_out})")
                if inp[islot][0] != (lid, 0):
                    raise HazardError(
                        f"FC L{lid}: input slot {islot} holds "
                        f"{inp[islot][0]}")
                if wgt[wslot][0] != (lid, 0):
                    raise HazardError(
                        f"FC L{lid}: weight slot {wslot} holds "
                        f"{wgt[wslot][0]}")
                if bias[0] != (lid,):
                    raise HazardError(f"FC L{lid}: stale bias buffer")
                blocks[(0, 0)] = self.fc(cl, ins, inp[islot][1],
                                         wgt[wslot][1], bias[1])
                stats["fc"] += 1
            elif op == Opcode.ELTWISE_ADD:
                pslot = ins.buff_base & 1
                sslot = (ins.buff_base >> 1) & 1
                n_el = cl.spec.h * cl.spec.w * cl.spec.c
                if ins.size != n_el:
                    raise HazardError(
                        f"ELTWISE L{lid}: word3 element count "
                        f"{ins.size} disagrees with compiled spec ({n_el})")
                if ins.dram_base != cl.skip_addr:
                    raise HazardError(
                        f"ELTWISE L{lid}: word2 skip base "
                        f"{ins.dram_base} disagrees with compiled skip operand "
                        f"({cl.skip_addr})")
                if inp[pslot][0] != (lid, 0):
                    raise HazardError(
                        f"ELTWISE L{lid}: primary input slot {pslot} "
                        f"holds {inp[pslot][0]}")
                if inp[sslot][0] != (lid, 1):
                    raise HazardError(
                        f"ELTWISE L{lid}: skip input slot {sslot} "
                        f"holds {inp[sslot][0]}")
                blocks[(0, 0)] = self.eltwise(cl, ins, inp[pslot][1],
                                              inp[sslot][1])
                stats["eltwise"] += 1
            elif op == Opcode.DEPTHWISE_CONV:
                islot = ins.buff_base & 1
                wslot = (ins.buff_base >> 1) & 1
                geom = unpack_dw_geom(ins.size)
                if geom != (cl.spec.r, cl.spec.s, cl.spec.stride):
                    raise HazardError(
                        f"DEPTHWISE L{lid}: word3 geometry {geom} "
                        f"disagrees with compiled spec "
                        f"({cl.spec.r}, {cl.spec.s}, {cl.spec.stride})")
                if inp[islot][0] != (lid, 0):
                    raise HazardError(
                        f"DEPTHWISE L{lid}: input slot {islot} holds "
                        f"{inp[islot][0]}")
                if wgt[wslot][0] != (lid, 0):
                    raise HazardError(
                        f"DEPTHWISE L{lid}: weight slot {wslot} holds "
                        f"{wgt[wslot][0]}")
                if bias[0] != (lid,):
                    raise HazardError(
                        f"DEPTHWISE L{lid}: stale bias buffer")
                blocks[(0, 0)] = self.depthwise(cl, ins, inp[islot][1],
                                                wgt[wslot][1], bias[1])
                stats["dw"] += 1
            elif op == Opcode.SAVE:
                ih = ins.size & 0xFFF
                kg = (ins.size >> 12) & 0xFFF
                if cl.kind != "conv":
                    need = [(0, 0)]
                elif cl.plan.dataflow == "is":
                    need = [(ih, g) for g in range(len(cl.k_groups))]
                else:
                    need = [(ih, kg)]
                for key in need:
                    if key not in blocks:
                        raise HazardError(
                            f"SAVE L{lid} block {key} not computed")
                self.save(cl, ins, [blocks.pop(key) for key in need])
                saved = True
                stats["save"] += 1
            else:
                raise ValueError(op)

        if cur_layer < 0:
            raise HazardError("empty instruction stream")
        self._end_layer(program.layers[cur_layer], blocks, saved)

    def _end_layer(self, cl, blocks: dict, saved: bool) -> None:
        if blocks:
            raise HazardError(
                f"layer {cl.layer_id}: {len(blocks)} COMP blocks never SAVEd")
        if not saved:
            raise HazardError(f"layer {cl.layer_id}: no SAVE executed")
        self.flush(cl)


def validate_schedule(program: Program) -> dict[str, int]:
    """Replay the hazard/FIFO discipline once, without any compute.

    Returns the pipeline statistics counters; raises :class:`HazardError`
    on the first violation.
    """
    stats = _fresh_stats()
    ScheduleWalk().walk(program, stats)
    return stats


# ---------------------------------------------------------------------------
# Phase 2: lowering to tensor ops
# ---------------------------------------------------------------------------

def slice_input_rows(cl: CompiledLayer, x_nhwc: torch.Tensor,
                     ih: int) -> torch.Tensor:
    """Input rows (plus halo) for output row group ``ih``."""
    r0, r1 = cl.row_groups[ih]
    return slice_input_span(cl, x_nhwc, r0, r1)


def _input_span(cl: CompiledLayer, r0: int, r1: int) -> tuple[int, int]:
    """Input rows ``[in_lo, in_hi)`` (spec-derived halo included; they may
    reach past the map, into the vertical padding) of output rows
    ``[r0, r1)``."""
    spec = cl.spec
    pad = (same_pad(spec.h, spec.r, spec.stride)[0]
           if spec.padding.upper() == "SAME" else 0)
    return r0 * spec.stride - pad, (r1 - 1) * spec.stride + spec.r - pad


def slice_input_span(cl: CompiledLayer, x_nhwc: torch.Tensor,
                     r0: int, r1: int) -> torch.Tensor:
    """Input rows (plus spec-derived halo) for output rows ``[r0, r1)``,
    with the vertical padding materialized."""
    in_lo, in_hi = _input_span(cl, r0, r1)
    h = cl.spec.h
    pad_top = max(0, -in_lo)
    pad_bot = max(0, in_hi - h)
    sl = x_nhwc[:, max(0, in_lo):min(h, in_hi)]
    if pad_top or pad_bot:
        sl = torch.nn.functional.pad(sl, (0, 0, 0, 0, pad_top, pad_bot))
    return sl


def height_pad(cl: CompiledLayer) -> tuple[int, int]:
    """Vertical conv padding of the whole layer: the rows
    :func:`slice_input_span` materializes for all of its output rows."""
    in_lo, in_hi = _input_span(cl, 0, cl.spec.out_hw[0])
    return max(0, -in_lo), max(0, in_hi - cl.spec.h)


def width_pad(cl: CompiledLayer) -> tuple[int, int]:
    """Horizontal conv padding (vertical halo is materialized by the slice)."""
    if cl.spec.padding.upper() == "SAME":
        return same_pad(cl.spec.w, cl.spec.s, cl.spec.stride)
    return (0, 0)


def conv_block_forward(cl: CompiledLayer, x_slab: torch.Tensor,
                       w_grp: torch.Tensor, b_grp: torch.Tensor, relu: bool,
                       *, backend: str = "torch",
                       quant: LayerQuant | None = None,
                       k_range: tuple[int, int] | None = None,
                       hpad: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """One COMP block on the selected PE backend.

    ``x_slab`` is the row-group slice (halo included, vertical padding
    materialized), or for a fp32 Spatial block the whole map with its
    vertical padding ``hpad`` (read as geometry); ``w_grp`` the k-group
    slice of the DRAM weight image (U-space for Winograd). ``quant``
    switches the block to the int8 PE (int8 in and weights, int32
    accumulate, fused requantize(+ReLU) epilogue) — Spatial mode only. When ``w_grp``/``b_grp`` are a k-group
    slice of the layer, ``k_range=(lo, hi)`` slices a per-channel
    multiplier to match.
    """
    spec, plan = cl.spec, cl.plan
    wpad = width_pad(cl)
    if quant is not None:
        if plan.mode == "wino":
            raise ValueError(
                f"layer {cl.layer_id}: Winograd plans cannot execute int8 "
                f"(the U-space transform is fp-only) — rebuild with "
                f"dtype='int8' so the DSE falls back to spatial")
        return qconv2d(x_slab, w_grp, b_grp,
                       mult=layer_multiplier(quant, x_slab.device, k_range),
                       stride=spec.stride, padding=((0, 0), wpad),
                       relu=relu, backend=backend)
    if plan.mode == "wino":
        if backend == "hopper":
            # K3 takes the width pad as geometry: no padded copy of the slab
            from repro_torch.kernels.winograd import (
                winograd_apply_pretransformed_hopper,
            )
            return winograd_apply_pretransformed_hopper(
                x_slab, w_grp, b_grp, m=plan.m, relu=relu,
                padding=((0, 0), wpad), dataflow=plan.dataflow)
        x_p = torch.nn.functional.pad(x_slab, (0, 0, wpad[0], wpad[1]))
        return winograd_apply_pretransformed(
            x_p, w_grp, b_grp, plan.m, relu=relu, padding="VALID")
    # the aten lowering is dataflow-oblivious, so only the hopper PE gets
    # the plan's dataflow
    hopper = backend == "hopper"
    return hybrid_conv2d(
        x_slab, w_grp, b_grp, mode="spat",
        dataflow=plan.dataflow if hopper else "is", stride=spec.stride,
        relu=relu, padding=(hpad, wpad), backend=backend)


# ---------------------------------------------------------------------------
# Lowering optimizer: per-layer block-structure analysis (opt_level=1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerLowering:
    """The optimizer's verdict for one layer.

    ``kind``: ``"fused"`` (one whole-layer PE dispatch; ``relu`` holds the
    uniform bit), ``"stacked"`` (mixed RELU bits over equal, contiguous
    k-groups: one PE call plus a static per-block ReLU mask, torch backend
    only), ``"block"`` (keep the literal per-block lowering; ``reason``
    says why) or ``"single"`` (ELTWISE_ADD / DEPTHWISE_CONV, one dispatch
    by construction).
    """
    kind: str
    relu: bool | None = None
    relu_blocks: tuple[tuple[bool, ...], ...] | None = None
    reason: str = ""


def _tiles_contiguously(groups, total: int) -> bool:
    lo = 0
    for a, b in groups:
        if a != lo or b <= a:
            return False
        lo = b
    return lo == total


def _stream_overrides(program: Program):
    """Per-block RELU bits and POOL configs, read off the instruction
    stream — the stream is authoritative over the compiled specs."""
    relu_bits: dict[tuple[int, int, int], bool] = {}
    pool_cfg: dict[int, tuple[int, int]] = {}
    for ins in program.instructions:
        if ins.opcode == Opcode.COMP:
            ih = ins.size & 0xFFF
            kg = (ins.size >> 12) & 0xFFF
            relu_bits[(ins.layer_id, ih, kg)] = ins.relu_flag
        elif ins.opcode in (Opcode.FC, Opcode.ELTWISE_ADD,
                            Opcode.DEPTHWISE_CONV):
            relu_bits[(ins.layer_id, 0, 0)] = ins.relu_flag
        elif ins.opcode == Opcode.POOL:
            pool_cfg[ins.layer_id] = (ins.pool_window, ins.pool_stride)
    return relu_bits, pool_cfg


def analyze_layer(cl: CompiledLayer, relu_of, *,
                  backend: str = "torch") -> LayerLowering:
    """Decide how one CONV layer may lower under ``opt_level=1``.

    ``relu_of(ih, kg)`` is the effective RELU bit of that COMP block.
    Fusion is claimed only when the whole-layer dispatch is provably the
    same math as the blocked assembly.
    """
    ho, _ = cl.spec.out_hw
    if not _tiles_contiguously(cl.row_groups, ho):
        return LayerLowering("block", reason="row groups do not tile H")
    if not _tiles_contiguously(cl.k_groups, cl.spec.k):
        return LayerLowering("block", reason="k-groups do not tile K")
    bits = {(ih, kg): bool(relu_of(ih, kg))
            for ih in range(len(cl.row_groups))
            for kg in range(len(cl.k_groups))}
    uniq = set(bits.values())
    if len(uniq) == 1:
        return LayerLowering("fused", relu=uniq.pop())
    if backend == "hopper":
        return LayerLowering(
            "block", reason="mixed RELU bits: the hopper PE keeps the "
                            "literal blocks")
    sizes = {hi - lo for lo, hi in cl.k_groups}
    if len(sizes) != 1:
        return LayerLowering(
            "block", reason="mixed RELU bits over unequal k-group sizes")
    relu_blocks = tuple(
        tuple(bits[(ih, kg)] for ih in range(len(cl.row_groups)))
        for kg in range(len(cl.k_groups)))
    return LayerLowering("stacked", relu_blocks=relu_blocks,
                         reason="mixed RELU bits")


def analyze_program(program: Program, *, backend: str = "torch",
                    relu_bits: dict | None = None
                    ) -> dict[int, LayerLowering]:
    """One :class:`LayerLowering` verdict per CONV, ELTWISE and DEPTHWISE
    layer (POOL and FC are one dispatch and stay implicit)."""
    if relu_bits is None:
        relu_bits, _ = _stream_overrides(program)
    out = {}
    for cl in program.layers:
        if cl.kind == "eltwise":
            out[cl.layer_id] = LayerLowering(
                "single", reason="ELTWISE_ADD is one two-source dispatch")
            continue
        if cl.kind == "dw":
            out[cl.layer_id] = LayerLowering(
                "single", reason="DEPTHWISE_CONV is one grouped-conv "
                                 "dispatch")
            continue
        if cl.kind != "conv":
            continue
        out[cl.layer_id] = analyze_layer(
            cl,
            lambda ih, kg, cl=cl: relu_bits.get((cl.layer_id, ih, kg),
                                                cl.spec.relu),
            backend=backend)
    return out


def _layer_forward_fused(cl: CompiledLayer, w_eff: torch.Tensor,
                         bias: torch.Tensor, x: torch.Tensor, relu: bool, *,
                         backend: str,
                         quant: LayerQuant | None = None) -> torch.Tensor:
    """One whole-layer PE dispatch — the blocked assembly collapsed to a
    single virtual block covering all rows and the full weight image.
    Valid under ``quant`` too: integer accumulation is exact, so the fused
    int32 sums equal the per-block sums bit for bit and the elementwise
    requantize epilogue commutes with the block partition."""
    ho, _ = cl.spec.out_hw
    if backend == "hopper" and quant is None and cl.plan.mode == "spat":
        # K1 takes the map as it lies and every pad as geometry: no padded
        # slab is copied
        blk = conv_block_forward(cl, x, w_eff, bias, relu, backend=backend,
                                 hpad=height_pad(cl))
    else:
        x_slab = slice_input_span(cl, x, 0, ho)
        blk = conv_block_forward(cl, x_slab, w_eff, bias, relu,
                                 backend=backend, quant=quant)
    return blk[:, :ho]


def _layer_forward_stacked(cl: CompiledLayer, w_eff: torch.Tensor,
                           bias: torch.Tensor, x: torch.Tensor,
                           lowering: LayerLowering, *,
                           backend: str) -> torch.Tensor:
    """Mixed-RELU layer as one PE call without ReLU over the whole weight
    image, then a static per-(k-group, row) ReLU mask. Output channels are
    independent, so this equals the per-block assembly."""
    ho, _ = cl.spec.out_hw
    x_slab = slice_input_span(cl, x, 0, ho)
    y = conv_block_forward(cl, x_slab, w_eff, bias, False,
                           backend=backend)[:, :ho]
    # filled on the device (no host copy, so a CUDA graph can capture it)
    mask = torch.zeros((ho, cl.spec.k), dtype=torch.bool, device=y.device)
    for kg, (lo, hi) in enumerate(cl.k_groups):
        for ih, (r0, r1) in enumerate(cl.row_groups):
            if lowering.relu_blocks[kg][ih]:
                mask[r0:r1, lo:hi] = True
    return torch.where(mask[None, :, None, :], torch.relu(y), y)


def _layer_forward(cl: CompiledLayer, w_eff: torch.Tensor, bias: torch.Tensor,
                   x_stored: torch.Tensor, relu_of, *, backend: str = "torch",
                   lowering: LayerLowering | None = None,
                   quant: LayerQuant | None = None) -> torch.Tensor:
    """One layer as blocked compute over the compiled (row, k) groups.

    ``w_eff`` is the DRAM-resident weight image: U-space ``(PT, PT, C, K)``
    for Winograd layers, raw ``(R, S, C, K)`` for Spatial. ``relu_of(ih,
    kg)`` is the COMP instruction's RELU bit for that block. ``lowering``
    is the optimizer's verdict (``None`` = the literal blocked lowering).
    """
    spec = cl.spec
    x = layouts.load_view(x_stored, cl.inp_layout, hw=(spec.h, spec.w))
    # the stacked form masks ReLU after the PE call — wrong under quant,
    # where ReLU must precede the requantize epilogue; keep the literal
    # blocked lowering for those (mixed-RELU) layers instead
    if quant is not None and lowering is not None \
            and lowering.kind == "stacked":
        lowering = None
    if lowering is not None and lowering.kind == "fused":
        y = _layer_forward_fused(cl, w_eff, bias, x, lowering.relu,
                                 backend=backend, quant=quant)
    elif lowering is not None and lowering.kind == "stacked":
        y = _layer_forward_stacked(cl, w_eff, bias, x, lowering,
                                   backend=backend)
    else:
        row_slabs = []
        for ih, (r0, r1) in enumerate(cl.row_groups):
            x_slab = slice_input_rows(cl, x, ih)
            k_blocks = []
            for kg, (lo, hi) in enumerate(cl.k_groups):
                blk = conv_block_forward(
                    cl, x_slab, w_eff[..., lo:hi].contiguous(), bias[lo:hi],
                    relu_of(ih, kg), backend=backend, quant=quant,
                    k_range=(lo, hi))
                k_blocks.append(blk[:, :r1 - r0])
            row_slabs.append(k_blocks[0] if len(k_blocks) == 1
                             else torch.cat(k_blocks, dim=-1))
        y = (row_slabs[0] if len(row_slabs) == 1
             else torch.cat(row_slabs, 1))
    if cl.out_layout == "wino":
        y = layouts.save_transform(y, "wino", cl.out_m)
    return y


def pool_forward(cl: CompiledLayer, x_stored: torch.Tensor,
                 window: int, stride: int) -> torch.Tensor:
    """One POOL block: identity LOAD view -> max pool, NHWC out. The
    SAVE-side layout reorder is applied by the caller."""
    x = layouts.load_view(x_stored, cl.inp_layout, hw=(cl.spec.h, cl.spec.w))
    return max_pool2d(x, window=window, stride=stride)


def fc_forward(cl: CompiledLayer, w: torch.Tensor, bias: torch.Tensor,
               x_stored: torch.Tensor, relu: bool, *,
               backend: str = "torch",
               quant: LayerQuant | None = None) -> torch.Tensor:
    """One FC layer: identity LOAD view, flatten (NHWC order), dense PE
    (the int8 GEMM PE when ``quant`` is set)."""
    x = layouts.load_view(x_stored, cl.inp_layout)
    x = x.reshape(x.shape[0], -1)
    if quant is not None:
        return qdense(x, w, bias,
                      mult=layer_multiplier(quant, x.device, None), relu=relu,
                      backend=backend)
    return dense(x, w, bias, relu=relu, backend=backend)


def eltwise_forward(cl: CompiledLayer, x_stored: torch.Tensor,
                    skip_stored: torch.Tensor, relu: bool,
                    quant: LayerQuant | None = None) -> torch.Tensor:
    """One ELTWISE_ADD block: two identity LOAD views -> add (+ ReLU), on
    both backends. Under ``quant`` the two int8 operands carry different
    scales, so the add runs through ``qeltwise`` (dequantize into output
    units, add, ReLU, requantize)."""
    hw = (cl.spec.h, cl.spec.w)
    a = layouts.load_view(x_stored, cl.inp_layout, hw=hw)
    b = layouts.load_view(skip_stored, cl.skip_layout, hw=hw)
    if quant is not None:
        return qeltwise(a, b, quant, relu)
    y = a.to(torch.float32) + b.to(torch.float32)
    if relu:
        y = torch.relu(y)
    return y.to(x_stored.dtype)


def depthwise_forward(cl: CompiledLayer, w: torch.Tensor, bias: torch.Tensor,
                      x_stored: torch.Tensor, relu: bool,
                      quant: LayerQuant | None = None) -> torch.Tensor:
    """One DEPTHWISE_CONV block: identity LOAD view -> per-channel conv, on
    both backends (``qdepthwise``, with its per-tensor multiplier, under
    ``quant``)."""
    x = layouts.load_view(x_stored, cl.inp_layout, hw=(cl.spec.h, cl.spec.w))
    if quant is not None:
        return qdepthwise(x, w, bias,
                          mult=layer_multiplier(quant, x.device, None),
                          stride=cl.spec.stride, padding=cl.spec.padding,
                          relu=relu)
    return depthwise_conv2d(x, w, bias, stride=cl.spec.stride,
                            padding=cl.spec.padding, relu=relu,
                            out_dtype=x_stored.dtype)


def n_param_layers(program: Program) -> int:
    """Layers that carry (w, bias) params — CONV, FC and DEPTHWISE."""
    return sum(cl.kind not in ("pool", "eltwise") for cl in program.layers)


def check_param_count(program: Program, params: list):
    if len(params) != n_param_layers(program):
        raise ValueError(
            f"expected {n_param_layers(program)} (w, bias) entries — one per "
            f"CONV/FC/DEPTHWISE layer in network order, POOL and ELTWISE "
            f"layers carry no params — got {len(params)}")


def check_lowerable(program: Program):
    """Raise ``ValueError`` for Winograd layers the runtime pre-transform
    cannot take."""
    for cl in program.layers:
        if cl.kind == "conv" and cl.plan.mode == "wino" \
                and (cl.spec.r, cl.spec.s) != (3, 3):
            raise ValueError(
                f"layer {cl.layer_id}: the runtime pre-transform supports "
                f"r = s = 3 (VGG family), got {cl.spec.r}x{cl.spec.s}")


def to_dram_params(program: Program, params: list) -> list:
    """Raw ``[(w, bias), ...]`` -> the DRAM weight image the executor
    consumes: U-space ``(PT, PT, C, K)`` for Winograd CONV layers, raw for
    Spatial CONV, FC and DEPTHWISE. Done once, the paper's offline
    transform."""
    check_param_count(program, params)
    check_lowerable(program)
    out = []
    it = iter(params)
    for cl in program.layers:
        if cl.kind in ("pool", "eltwise"):
            continue
        w, b = next(it)
        if cl.kind == "conv" and cl.plan.mode == "wino":
            w = transform_weights(w, cl.plan.m)
        out.append((w, b))
    return out


def lower_program(program: Program, *, backend: str = "torch",
                  opt_level: int = 1, quant: QuantSidecar | None = None
                  ) -> Callable[[list, torch.Tensor], torch.Tensor]:
    """Lower a validated schedule to ``execute(params, x_nhwc) -> y``.

    ``params`` is the per-layer **DRAM weight image** (see
    :func:`to_dram_params`), so requests never redo weight work.
    ``backend`` selects the per-block PE; ``opt_level=1`` runs the lowering
    optimizer and ``opt_level=0`` keeps the literal per-block lowering.
    ``quant`` lowers every parameterized block through the int8 PE: params
    must then be the quantized image (``quant.quantize_params``) and
    ``x_nhwc`` int8 at the sidecar's input scale.
    """
    backend = resolve_backend(backend)
    opt_level = resolve_opt_level(opt_level)
    check_lowerable(program)
    if quant is not None:
        for cl in program.layers:
            if cl.kind == "conv" and cl.plan.mode == "wino":
                raise ValueError(
                    f"layer {cl.layer_id}: Winograd plans cannot execute "
                    f"int8 — plan with the dtype='int8' DSE (wino falls "
                    f"back to spatial)")

    relu_bits, pool_cfg = _stream_overrides(program)
    lowerings = (analyze_program(program, backend=backend,
                                 relu_bits=relu_bits)
                 if opt_level >= 1 else {})

    # the stash holds every tensor a not-yet-executed consumer still needs
    # (a skip tensor stays live across its residual block), retired after
    # its last consumer as the compiler's DRAM planner does
    last_use: dict[int, int] = {}
    for cl in program.layers:
        srcs = {cl.primary_src()}
        if cl.kind == "eltwise":
            srcs.add(cl.skip_src)
        for src in srcs:
            last_use[src] = cl.layer_id

    def execute(params: list, x_nhwc: torch.Tensor) -> torch.Tensor:
        cl0 = program.layers[0]
        x = x_nhwc
        if cl0.inp_layout == "wino":
            x = layouts.save_transform(x, "wino", cl0.plan.m)
        stash: dict[int, torch.Tensor] = {-1: x}
        pi = 0
        y = x
        for cl in program.layers:
            x_in = stash[cl.primary_src()]
            lq = quant.layers[cl.layer_id] if quant is not None else None
            relu00 = (relu_bits.get((cl.layer_id, 0, 0), cl.spec.relu)
                      if cl.kind != "pool" else False)
            if cl.kind == "pool":
                window, stride = pool_cfg.get(
                    cl.layer_id, (cl.spec.window, cl.spec.stride))
                y = pool_forward(cl, x_in, window, stride)
            elif cl.kind == "eltwise":
                y = eltwise_forward(cl, x_in, stash[cl.skip_src], relu00,
                                    quant=lq)
            elif cl.kind == "fc":
                w_eff, b = params[pi]
                pi += 1
                y = fc_forward(cl, w_eff, b, x_in, relu00, backend=backend,
                               quant=lq)
            elif cl.kind == "dw":
                w_eff, b = params[pi]
                pi += 1
                y = depthwise_forward(cl, w_eff, b, x_in, relu00, quant=lq)
            else:
                w_eff, b = params[pi]
                pi += 1
                y = _layer_forward(
                    cl, w_eff, b, x_in,
                    lambda ih, kg, cl=cl: relu_bits.get((cl.layer_id, ih, kg),
                                                        cl.spec.relu),
                    backend=backend, lowering=lowerings.get(cl.layer_id),
                    quant=lq)
            # _layer_forward applies the SAVE-side reorder itself
            if cl.kind != "conv" and cl.out_layout == "wino":
                y = layouts.save_transform(y, "wino", cl.out_m)
            stash[cl.layer_id] = y
            for src in list(stash):
                if last_use.get(src, -2) <= cl.layer_id and src != cl.layer_id:
                    del stash[src]
        return y

    return execute


# ---------------------------------------------------------------------------
# Compiled executor: validation + lowering, captured into CUDA graphs
# ---------------------------------------------------------------------------

# graphs an entry keeps per weight set, one per stream it was replayed on
# most recently; past this many streams the weight set's least recently
# replayed graph is dropped (its pool memory returns to the stream's pool).
# The entry itself has no bound on its graphs: it keeps one per live weight
# set and stream, so weight sets taking turns on one stream (tenants of one
# program) each keep theirs, and a weight set that died takes its graphs
# with it
STREAMS_PER_WEIGHTS = 4

@dataclasses.dataclass(eq=False)
class _StreamPool:
    """One private memory pool, one capture stream and one lock per
    (device, stream): every live graph replayed on a stream shares its
    pool (captured on one side stream, so the allocator can hand one
    capture's freed blocks to the next), and a replay holds the lock from
    the copy into its static input to the copy out of its static output,
    so replays on the stream never interleave and no output is read after
    another graph reused its memory. Graphs replayed on different streams
    never share a pool. Once every graph of the pool has died the
    allocator may release the pool, which then takes no capture: the next
    capture opens a new one (``graphs`` holds the live ones weakly)."""
    side: "torch.cuda.Stream"
    lock: threading.Lock
    pool: tuple | None = None
    graphs: weakref.WeakSet = dataclasses.field(
        default_factory=weakref.WeakSet)


_stream_pools: dict[tuple[int, int], _StreamPool] = {}
_stream_pools_lock = threading.Lock()


def _stream_pool(device: torch.device, stream) -> _StreamPool:
    """The pool, capture stream and lock of the graphs replayed on
    ``stream``."""
    key = (device.index, stream.cuda_stream)
    with _stream_pools_lock:
        got = _stream_pools.get(key)
        if got is None:
            got = _stream_pools[key] = _StreamPool(torch.cuda.Stream(device),
                                                   threading.Lock())
    return got


def capture_graph(fn: Callable, device: torch.device, stream) -> tuple:
    """Capture ``fn()`` into one ``torch.cuda.CUDAGraph`` to replay on
    ``stream``: on the stream's side stream, into its pool
    (:func:`_stream_pool`), thread-local (the session's drain thread and
    other streams keep working meanwhile: event waits, pinned copies),
    recording the kernel launches and holding the cached device constants
    ``fn`` reads. The caller holds the stream's lock and has warmed ``fn``
    up. Returns (graph, ``fn``'s output, launches, constants, the
    capture's host ms). A failed capture raises."""
    sp = _stream_pool(device, stream)
    graph = torch.cuda.CUDAGraph()
    with _stream_pools_lock:
        if not sp.graphs:
            sp.pool = torch.cuda.graph_pool_handle()
        sp.graphs.add(graph)
        pool, side = sp.pool, sp.side
    side.wait_stream(stream)
    t0 = time.perf_counter()
    with (torch.cuda.stream(side), recording_launches() as counts,
          holding_constants() as constants):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    stream.wait_stream(side)
    return (graph, out, {k: v for k, v in counts.items() if v}, constants,
            (time.perf_counter() - t0) * 1e3)


@dataclasses.dataclass
class _Graph:
    """One capture of an entry: the graph, its static input and output,
    weak references to the params it was captured over, the cached device
    constants the capture read (kept: the cache may evict them while the
    graph reads their addresses), the kernel launches the capture recorded
    and its stream's lock."""
    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    y: torch.Tensor
    params: tuple
    constants: list
    launches: dict[str, int]
    lock: threading.Lock

    def alive(self) -> bool:
        """Every param it was captured over is still referenced outside
        the graph. A dead one may have freed its memory, so the graph is
        dropped, never replayed."""
        return all(ref() is not None for ref in self.params)


def _params_key(params: list) -> tuple:
    return tuple(t.data_ptr() for p in params for t in p)


class _GraphTable:
    """An entry's graphs by ``(stream, data_ptr of every param)``. Their
    number follows the live weight sets: a graph whose params died is
    dropped at the next lookup or insert, and each weight set keeps at most
    ``streams_per_weights`` graphs (one per stream, the least recently used
    dropped first). No live weight set ever loses its graph on a stream to
    another weight set's capture."""

    def __init__(self, streams_per_weights: int):
        self.streams_per_weights = streams_per_weights
        self._graphs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._graphs)

    def drop_dead(self) -> None:
        """Drop every graph whose params died."""
        with self._lock:
            for k in [k for k, v in self._graphs.items() if not v.alive()]:
                del self._graphs[k]

    def get(self, key):
        with self._lock:
            g = self._graphs.get(key)
            if g is None:
                return None
            if not g.alive():
                del self._graphs[key]
                return None
            self._graphs.move_to_end(key)
            return g

    def put(self, key, g) -> None:
        self.drop_dead()
        with self._lock:
            self._graphs[key] = g
            self._graphs.move_to_end(key)
            same = [k for k in self._graphs if k[1] == key[1]]  # oldest first
            for k in same[:max(0, len(same) - self.streams_per_weights)]:
                del self._graphs[k]


@dataclasses.dataclass
class CompiledExecutor:
    """The executor for one ``(Program, batch, dtype, backend, opt_level,
    donate_input, device, quant)`` entry.

    On a CUDA device an entry runs as CUDA graphs, the port's counterpart
    of the reference's trace-once ``jax.jit``: the first call on a stream
    over a set of weights runs the lowered function once uncaptured (the
    warm-up: kernel attributes, allocator, device constants) and returns
    its result, then captures the function into one ``torch.cuda.CUDAGraph``
    with a static input and output; later calls copy ``x`` into the static
    input, replay the graph and return a clone of the static output, which
    the caller owns. The graph reads the weights by address, so it is kept
    per ``(stream, data_ptr of every param)``: a call over other weights (a
    reloaded program of the same schedule) captures anew, and a graph is
    never replayed over weights it was not captured with, nor once one of
    them is no longer referenced outside it. The graphs follow the live
    weight sets: each keeps its own (at most ``STREAMS_PER_WEIGHTS``
    streams' worth, least recently used dropped first), so weight sets
    taking turns on one stream replay without capturing again. It keeps
    the cached device constants its capture read (the requantize
    multipliers). ``trace_count``
    counts the captures (0 on the CPU, where ``fn`` runs as it is), and
    each capture is an ``executor.capture`` span in ``repro_torch.spans``
    (id: the entry's ``id()``; count: the batch). A failed capture raises; nothing falls back to the
    uncaptured path.

    ``donate_input`` (the reference's input donation) marks an entry whose
    caller hands over its input buffer until the batch completes: it may
    pass a pinned host tensor, copied straight into the static input on
    the caller's stream (the serving session's staging). ``aot_loaded``:
    ``fn`` came from an AOT bundle (``core/aot.py``), not a lowering
    (``build_count`` 0).
    """
    program: Program
    stats: dict[str, int]          # schedule-validation pipeline counters
    fn: Callable                   # execute(params, x), uncaptured
    build_count: int = 1           # lowerings behind this entry (0 or 1)
    backend: str = "torch"
    opt_level: int = 1
    donate_input: bool = False     # the caller hands x over (see above)
    aot_loaded: bool = False       # fn deserialized from an AOT bundle
    # the device the executor's tensors live on; no default, so a card's
    # executor is never labelled as the CPU's
    device: str = dataclasses.field(kw_only=True)
    _graphs: _GraphTable = dataclasses.field(
        default_factory=lambda: _GraphTable(STREAMS_PER_WEIGHTS),
        repr=False)
    _trace_count: int = dataclasses.field(default=0, repr=False)
    _capture_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    mesh_key = None                # unsharded (see ShardedExecutor)

    @property
    def trace_count(self) -> int:
        """CUDA-graph captures behind this entry (the retrace probe)."""
        return self._trace_count

    def __call__(self, params: list, x_nhwc: torch.Tensor) -> torch.Tensor:
        """``params`` is the DRAM weight image (see :func:`to_dram_params`);
        on a CUDA entry ``x_nhwc`` may lie on the card or, pinned, on the
        host."""
        with torch.no_grad():
            if not self.device.startswith("cuda"):
                return self.fn(params, x_nhwc)
            return self._replay(params, x_nhwc)

    def _replay(self, params: list, x: torch.Tensor) -> torch.Tensor:
        device = torch.device(self.device)
        stream = torch.cuda.current_stream(device)
        key = (stream.cuda_stream, _params_key(params))
        while (g := self._graphs.get(key)) is None:
            y = self._capture(key, params, x, device, stream)
            if y is not None:
                return y
            # another thread captured it first: look it up again
        if tuple(x.shape) != tuple(g.x.shape) or x.dtype != g.x.dtype:
            raise ValueError(f"executor entry takes {tuple(g.x.shape)} "
                             f"{g.x.dtype}, got {tuple(x.shape)} {x.dtype}")
        with g.lock:
            if x.data_ptr() != g.x.data_ptr():
                g.x.copy_(x, non_blocking=True)
            g.graph.replay()
            y = g.y.clone()
            add_launches(g.launches)
        return y

    def _capture(self, key, params: list, x: torch.Tensor,
                 device: torch.device, stream) -> torch.Tensor:
        """Warm up, then capture this entry's graph for ``key``; returns the
        warm-up's result, or None when another thread captured ``key``
        meanwhile."""
        lock = _stream_pool(device, stream).lock
        with self._capture_lock, lock:
            if self._graphs.get(key) is not None:
                return None
            # the warm-up: its result answers this call
            x_dev = x.to(device, non_blocking=True)
            y = self.fn(params, x_dev)
            static_x = torch.empty_like(x_dev)
            static_x.copy_(x_dev)
            with spans.span(spans.CAPTURE, id(self), count=x.shape[0]):
                graph, static_y, launches, constants, _ = capture_graph(
                    lambda: self.fn(params, static_x), device, stream)
            self._graphs.put(key, _Graph(
                graph, static_x, static_y,
                tuple(weakref.ref(t) for p in params for t in p), constants,
                launches, lock))
            self._trace_count += 1
        return y


def mesh_key(mesh) -> tuple | None:
    """Hashable topology key for a device mesh (``None`` = unsharded):
    its shape, axis names and each position's ``(type, index)``. Two
    meshes over other devices, or the same devices in another order, key
    apart, and so does a mesh that repeats a device from one that holds
    it once."""
    if mesh is None:
        return None
    return (tuple(mesh.devices.shape), tuple(mesh.axis_names),
            tuple((d.type, d.index) for d in mesh.devices.flat))


def mesh_device_count(mesh) -> int:
    """Positions (replicas) of ``mesh``; 1 for ``None``. A repeated device
    counts once per position."""
    if mesh is None:
        return 1
    return int(mesh.devices.size)


@dataclasses.dataclass
class ShardedExecutor:
    """The sharded variant of an entry, over a mesh of ``n`` positions:
    the port's counterpart of the reference's ``shard_map`` over the batch
    axis. The batch is split on dim 0 into ``n`` equal shards, position
    ``i`` takes shard ``i``, params are replicated (the caller passes one
    weight image per position, ``HybridRuntime.executor_entry(mesh=)``),
    and each shard runs the whole per-shard program as an ordinary
    single-device :class:`CompiledExecutor` (``shards[i]``, captured as CUDA
    graphs on its device's current stream). Positions on one device share
    one such entry, so a repeated device replays one graph per shard, one
    after the other, each replay holding the stream's lock. The output is
    gathered on the mesh's first device, on its current stream, after an
    event recorded on every other device's stream."""
    program: Program
    stats: dict[str, int]
    shards: tuple                  # one CompiledExecutor per position
    mesh_key: tuple
    backend: str = "torch"
    opt_level: int = 1
    donate_input: bool = False
    device: str = dataclasses.field(kw_only=True)   # the mesh's first device
    aot_loaded: bool = False       # never: a sharded entry is always lowered

    @property
    def trace_count(self) -> int:
        """CUDA-graph captures behind this entry's distinct shard entries."""
        return sum(e.trace_count for e in {id(e): e for e in
                                           self.shards}.values())

    def _split(self, params: list, x: torch.Tensor):
        n = len(self.shards)
        if len(params) != n:
            raise ValueError(f"sharded entry takes one weight image per mesh "
                             f"position ({n}), got {len(params)}")
        if x.shape[0] % n:
            raise ValueError(f"sharded entry: batch {x.shape[0]} does not "
                             f"divide over the mesh's {n} positions")
        per = x.shape[0] // n
        return [(e, p, x[i * per:(i + 1) * per])
                for i, (e, p) in enumerate(zip(self.shards, params))]

    def _gather(self, outs: list) -> torch.Tensor:
        first = torch.device(self.device)
        if first.type == "cuda":
            s0 = torch.cuda.current_stream(first)
            for e, y in zip(self.shards, outs):
                if torch.device(e.device) != first:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(y.device))
                    s0.wait_event(ev)
        return torch.cat([y.to(first, non_blocking=True) for y in outs])

    def __call__(self, params: list, x_nhwc: torch.Tensor) -> torch.Tensor:
        """``params``: one DRAM weight image per mesh position; ``x_nhwc``
        the whole batch (on the first device or, pinned, on the host)."""
        return self._gather([e(p, xs) for e, p, xs in
                             self._split(params, x_nhwc)])

    def fn(self, params: list, x_nhwc: torch.Tensor) -> torch.Tensor:
        """The uncaptured sharded function: each shard through its entry's
        ``fn`` on its device."""
        with torch.no_grad():
            return self._gather([
                e.fn(p, xs.to(e.device, non_blocking=True))
                for e, p, xs in self._split(params, x_nhwc)])


def warm_device_constants(program: Program, *, backend: str,
                          device, quant: QuantSidecar | None = None) -> None:
    """Make the device constants the lowered function reads (requantize
    multipliers, the torch backend's Winograd matrices) before its first
    call, so neither a CUDA graph's capture nor ``torch.export``'s trace
    creates one."""
    device = torch.device(device)
    for cl in program.layers:
        if quant is not None and cl.kind in ("conv", "fc", "dw"):
            lq = quant.layers[cl.layer_id]
            layer_multiplier(lq, device, None)
            if cl.kind == "conv":
                for lo, hi in cl.k_groups:
                    layer_multiplier(lq, device, (lo, hi))
        if (cl.kind == "conv" and cl.plan.mode == "wino"
                and backend == "torch"):
            for which in range(3):
                wino._matrix(cl.plan.m, which, device)


def compile_executor(program: Program,
                     stats: dict[str, int] | None = None, *,
                     backend: str = "torch", opt_level: int = 1,
                     donate_input: bool = False, device,
                     quant: QuantSidecar | None = None, mesh=None):
    """Validate (unless pre-validated stats are supplied) and lower
    (through the int8 PE when ``quant`` is set).

    ``mesh`` of more than one position builds the sharded variant
    (:class:`ShardedExecutor`, one single-device entry per distinct device
    of the mesh over one lowering; the batch must divide over the
    positions, which the program cache checks where the batch is known).
    A mesh of one position lowers exactly as ``mesh=None`` on ``device``.
    """
    if stats is None:
        stats = validate_schedule(program)
    backend = resolve_backend(backend)
    opt_level = resolve_opt_level(opt_level)
    execute = lower_program(program, backend=backend, opt_level=opt_level,
                            quant=quant)

    def single(dev) -> CompiledExecutor:
        warm_device_constants(program, backend=backend, device=dev,
                              quant=quant)
        return CompiledExecutor(program=program, stats=dict(stats),
                                fn=execute, backend=backend,
                                opt_level=opt_level,
                                donate_input=bool(donate_input),
                                device=str(dev))

    if mesh_device_count(mesh) == 1:
        return single(device)
    by_device: dict[str, CompiledExecutor] = {}
    for d in mesh.devices.flat:
        if str(d) not in by_device:
            by_device[str(d)] = single(d)
    shards = tuple(by_device[str(d)] for d in mesh.devices.flat)
    return ShardedExecutor(program=program, stats=dict(stats), shards=shards,
                           mesh_key=mesh_key(mesh), backend=backend,
                           opt_level=opt_level,
                           donate_input=bool(donate_input),
                           device=shards[0].device)
