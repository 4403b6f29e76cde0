"""HybridDNN compiler: DNN graph + DSE plan -> 128-bit instruction stream.

``compile_network`` accepts the FULL layer sequence of a model — ``ConvSpec``
CONV layers, ``PoolSpec`` maxpools, ``FCSpec`` fully-connected layers,
``EltwiseSpec`` residual adds, and ``DepthwiseSpec`` depthwise convolutions —
and lowers it into ONE instruction stream (one ``Program``). The compiler
fully controls data movement (Sec. 4.1): DRAM buffer planning runs across
what used to be per-CONV-segment boundaries, POOL layers are a
LOAD_INP/POOL/SAVE block, FC layers a LOAD_BIAS/LOAD_INP/LOAD_WGT/FC/SAVE
block, ELTWISE layers a two-source LOAD_INP/LOAD_INP/ELTWISE_ADD/SAVE block,
and DEPTHWISE layers a LOAD_BIAS/LOAD_INP/LOAD_WGT/DEPTHWISE_CONV/SAVE
block, all under the same handshake-FIFO hazard discipline as CONV.

The network is no longer a straight line: a ``ConvSpec`` may reroute its
input (``inp_from`` — ResNet projection shortcuts read the block input) and
an ``EltwiseSpec`` names a second source (``skip_from``). DRAM activation
planning is therefore liveness-driven: every activation buffer lives until
its LAST consumer (which keeps a skip tensor live across the whole residual
block) and is then recycled through an exact-fit free list, so the
high-water mark stays close to the straight-line bump allocator's. Weights
and biases are written once by ``load_params`` before execution and are
never recycled — an activation may not alias them.

For CONV layers it implements the operation partition of Sec. 4.2.4 and the
IS/WS loop orders of Figure 4:

* feature maps are partitioned into ``G_H`` row groups (``H`` for Spatial,
  ``H/m`` for Winograd — we use a configurable group height that defaults to
  the largest on-chip-fitting slab, the paper's per-row case being the
  finest),
* weights are partitioned into ``G_K`` groups along output channels,
* IS: for each input group, stream all weight groups; WS: for each weight
  group, stream all input groups.

DRAM addresses come from a bump allocator (words); BUFF_BASE alternates
between ping-pong slots 0/1 so that LOAD(i+1) can overlap COMP(i) — the
runtime checks the resulting hazard discipline with handshake tokens.

Winograd-mode weights are written to DRAM *pre-transformed* (Sec. 4.2.3
offline transform), so LOAD_WGT sizes reproduce Eq. 8 vs Eq. 9's bandwidth
asymmetry exactly.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from repro_torch.core.hybrid_conv import (
    ConvSpec,
    DepthwiseSpec,
    EltwiseSpec,
    FCSpec,
    PoolSpec,
    same_pad,
)
from repro_torch.core.isa import (
    Instruction,
    Opcode,
    encode_stream,
    pack_dw_geom,
    pack_fc_dims,
)
from repro_torch.core.layouts import layout_for_mode
from repro_torch.core.winograd import R_WINO, pt_for


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Per-layer software parameters chosen by the DSE (Table 2)."""
    mode: str = "spat"          # "spat" | "wino"
    dataflow: str = "is"        # "is" | "ws"
    m: int = 4                  # Winograd output tile size (PT = m + 2)
    g_k: int = 1                # weight groups along output channels
    g_h: int = 1                # input-row groups


@dataclasses.dataclass(frozen=True)
class CompiledLayer:
    spec: ConvSpec | PoolSpec | FCSpec | EltwiseSpec | DepthwiseSpec
    plan: LayerPlan
    layer_id: int
    inp_addr: int               # DRAM base of this layer's input fmap
    wgt_addr: int               # DRAM base of (possibly transformed) weights
    bias_addr: int              # (-1 for layers without weights/bias)
    out_addr: int
    inp_layout: str             # layout the input is stored in ("spat"/"wino")
    out_layout: str             # layout SAVE writes for the next layer
    out_m: int                  # tile size of the WINO out layout (next layer's m)
    # derived group geometry
    row_groups: tuple[tuple[int, int], ...]   # output-row ranges per group
    k_groups: tuple[tuple[int, int], ...]     # output-channel ranges
    kind: str = "conv"          # "conv" | "pool" | "fc" | "eltwise" | "dw"
    # dataflow wiring (skip connections / rerouted inputs)
    inp_src: int = -2           # producer layer id of the primary input
    #                             (-1 = network input; -2 = "previous layer",
    #                             the legacy sentinel for layers built
    #                             without explicit wiring)
    skip_src: int = -2          # ELTWISE only: producer of the skip operand
    skip_addr: int = -1         # ELTWISE only: DRAM base of the skip operand
    skip_layout: str = "spat"   # layout the skip operand is stored in

    def primary_src(self) -> int:
        """Producer layer id of the primary input (-1 = network input)."""
        return self.layer_id - 1 if self.inp_src == -2 else self.inp_src


@dataclasses.dataclass
class Program:
    instructions: list[Instruction]
    layers: list[CompiledLayer]
    dram_size_words: int
    _schedule_key: str | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def instruction_image(self) -> np.ndarray:
        """The encoded uint32[n, 4] instruction-memory image — the on-disk /
        on-device representation, bit-equal to the reference package's image
        for the same specs and plans."""
        return encode_stream(self.instructions)

    def schedule_key(self) -> str:
        """Content hash of the schedule — the program-cache identity.

        Covers the encoded 128-bit instruction image plus every static
        field the executor lowers against (spec, plan, group geometry,
        layouts); DRAM addresses are deliberately included via the encoded
        stream so two programs only alias if their streams are bit-equal.
        """
        if self._schedule_key is None:
            h = hashlib.sha256()
            h.update(encode_stream(self.instructions).tobytes())
            for cl in self.layers:
                h.update(repr((cl.kind, cl.spec, cl.plan, cl.row_groups,
                               cl.k_groups, cl.inp_layout, cl.out_layout,
                               cl.out_m, cl.inp_src, cl.skip_src,
                               cl.skip_layout)).encode())
            self._schedule_key = h.hexdigest()
        return self._schedule_key


def _split(total: int, groups: int, align: int = 1) -> list[tuple[int, int]]:
    """Split [0, total) into ~equal ranges aligned to ``align``."""
    groups = max(1, min(groups, math.ceil(total / align)))
    base = math.ceil(total / groups / align) * align
    out = []
    lo = 0
    while lo < total:
        hi = min(total, lo + base)
        out.append((lo, hi))
        lo = hi
    return out


def _wgt_words(spec: ConvSpec, plan: LayerPlan, k_lo: int, k_hi: int) -> int:
    """Weight transfer size in words; Winograd weights are pre-transformed
    (ceil(R/r)*ceil(S/r)*PT^2 words per (c,k) — Eq. 9's numerator)."""
    kk = k_hi - k_lo
    if plan.mode == "wino":
        pt = pt_for(plan.m)
        nr = math.ceil(spec.r / R_WINO) * math.ceil(spec.s / R_WINO)
        return kk * spec.c * nr * pt * pt
    return kk * spec.c * spec.r * spec.s


def _inp_words(spec: ConvSpec, row_lo: int, row_hi: int) -> int:
    """Input rows needed for output rows [row_lo, row_hi) incl. halo."""
    pad = (same_pad(spec.h, spec.r, spec.stride)[0]
           if spec.padding.upper() == "SAME" else 0)
    in_lo = max(0, row_lo * spec.stride - pad)
    in_hi = min(spec.h, (row_hi - 1) * spec.stride + spec.r - pad)
    return (in_hi - in_lo) * spec.w * spec.c


def _kind(spec) -> str:
    if isinstance(spec, PoolSpec):
        return "pool"
    if isinstance(spec, FCSpec):
        return "fc"
    if isinstance(spec, EltwiseSpec):
        return "eltwise"
    if isinstance(spec, DepthwiseSpec):
        return "dw"
    return "conv"


def _sources(lid: int, spec) -> list[int]:
    """Producer layer ids layer ``lid`` reads (-1 = network input).

    The first entry is always the primary input; an ``EltwiseSpec``
    additionally reads its ``skip_from`` operand.
    """
    if isinstance(spec, ConvSpec) and spec.inp_from is not None:
        srcs = [spec.inp_from]
    else:
        srcs = [lid - 1]
    if isinstance(spec, EltwiseSpec):
        srcs.append(spec.skip_from)
    return srcs


def _out_shape(spec) -> tuple[int, int, int] | None:
    """(ho, wo, channels) of a layer's output fmap; None for FC (a vector
    output cannot feed a skip connection or a rerouted conv)."""
    if isinstance(spec, FCSpec):
        return None
    ho, wo = spec.out_hw
    ch = spec.k if isinstance(spec, ConvSpec) else spec.c
    return (ho, wo, ch)


# fixed plan for layers the DSE does not parameterize (pool/fc); the DSE
# emits the same sentinel so DSE-produced and compiler-normalized
# CompiledLayer.plan (and thus schedule keys) can never drift
NO_PLAN = LayerPlan("spat", "is")


def compile_network(
    specs: list[ConvSpec | PoolSpec | FCSpec | EltwiseSpec | DepthwiseSpec],
    plans: list[LayerPlan | None],
    *,
    input_layout: str | None = None,
) -> Program:
    """Compile a full layer chain (CONV / POOL / FC / ELTWISE / DEPTHWISE)
    into ONE instruction stream.

    ``plans`` aligns with ``specs``; entries for non-CONV layers are ignored
    (``None`` is accepted). The LOAD module only performs identity loads
    (Sec. 4.3), so the network input must be stored in the layout of layer
    0's mode — the runtime's ``write_input`` does that host-side conversion.
    SAVE always writes the layout the *next consumer* wants: tile-major WINO
    only when the sole consumer is the sequential next CONV in Winograd
    mode; outputs with a skip/rerouted consumer (or a POOL/FC/ELTWISE/DW
    successor) store SPAT.

    DRAM activation buffers are liveness-planned: each fmap lives until its
    LAST consumer (an ``EltwiseSpec.skip_from`` or ``ConvSpec.inp_from``
    reference extends the producer's lifetime across the residual block),
    then its address range is recycled through an exact-fit free list.
    """
    assert len(specs) == len(plans)
    plans = [NO_PLAN if _kind(s) != "conv" else p
             for s, p in zip(specs, plans)]
    if input_layout is None:
        input_layout = (layout_for_mode(plans[0].mode)
                        if _kind(specs[0]) == "conv" else "spat")

    # -- dataflow graph: sources, consumers, liveness -------------------
    consumers: dict[int, list[int]] = {}
    for lid, spec in enumerate(specs):
        srcs = _sources(lid, spec)
        # the primary source is explicitly wired only via ConvSpec.inp_from;
        # every extra source (an EltwiseSpec skip) is explicit by definition
        explicit = [isinstance(spec, ConvSpec) and spec.inp_from is not None]
        explicit += [True] * (len(srcs) - 1)
        for src, exp in zip(srcs, explicit):
            if not -1 <= src < lid:
                raise ValueError(
                    f"layer {lid} ({spec.name!r}) reads layer {src}: "
                    f"sources must be earlier layers (-1 = network input)")
            if exp and src >= 0 and _out_shape(specs[src]) is None:
                raise ValueError(
                    f"layer {lid} ({spec.name!r}) reads FC layer {src} "
                    f"({specs[src].name!r}): an FC output cannot feed a "
                    f"skip/rerouted fmap consumer")
            consumers.setdefault(src, []).append(lid)
    last_use = {src: max(lids) for src, lids in consumers.items()}

    def src_shape(src: int) -> tuple[int, int, int] | None:
        if src == -1:
            s0 = specs[0]
            return None if _kind(s0) == "fc" else (s0.h, s0.w, s0.c)
        return _out_shape(specs[src])

    def check_operand(lid: int, spec, src: int, operand: str):
        have = src_shape(src)
        want = (spec.h, spec.w, spec.c)
        if have != want:
            raise ValueError(
                f"layer {lid} ({spec.name!r}) {operand} reads layer {src} "
                f"shaped {have}, expected {want}")

    instrs: list[Instruction] = []
    layers: list[CompiledLayer] = []
    alloc = 0
    free: list[tuple[int, int]] = []    # recycled activation (addr, words)

    def bump(words: int) -> int:
        nonlocal alloc
        base = alloc
        alloc += words
        return base

    def alloc_act(words: int) -> int:
        # exact-fit reuse of DEAD activation buffers only. Weights/biases
        # always bump: load_params writes them once before execution, so a
        # run-time activation write may never alias them.
        for i, (addr, w) in enumerate(free):
            if w == words:
                free.pop(i)
                return addr
        return bump(words)

    def out_layout_for(lid: int) -> tuple[str, int]:
        """Layout SAVE(lid) writes = what the consumer's LOAD wants."""
        cons = consumers.get(lid, [])
        if (cons == [lid + 1] and _kind(specs[lid + 1]) == "conv"
                and specs[lid + 1].inp_from is None):
            nxt = plans[lid + 1]
            layout = layout_for_mode(nxt.mode)
            return layout, (nxt.m if layout == "wino" else 0)
        return "spat", 0

    # allocate DRAM: input of layer 0, then per layer (weights, bias, output)
    s0 = specs[0]
    in_words = s0.d_in if _kind(s0) == "fc" else s0.h * s0.w * s0.c
    # produced[src] = (addr, words, stored layout) of every fmap a
    # not-yet-executed consumer may still read; entries are popped when
    # their last consumer retires, so a stale read is a loud KeyError
    produced: dict[int, tuple[int, int, str]] = {
        -1: (bump(in_words), in_words, input_layout)}

    for lid, (spec, plan) in enumerate(zip(specs, plans)):
        kind = _kind(spec)
        out_layout, out_m = out_layout_for(lid)
        psrc = _sources(lid, spec)[0]
        if kind == "conv" and spec.inp_from is not None:
            check_operand(lid, spec, psrc, "input (inp_from)")
        inp_addr, _, inp_layout = produced[psrc]

        def finish(cl: CompiledLayer, words: int):
            """Register the layer + its output fmap, retire dead sources."""
            layers.append(cl)
            produced[lid] = (cl.out_addr, words, cl.out_layout)
            for src in set(_sources(lid, spec)):
                if last_use.get(src) == lid:
                    addr, w, _ = produced.pop(src)
                    free.append((addr, w))

        if kind == "pool":
            ho, wo = spec.out_hw
            out_addr = alloc_act(ho * wo * spec.c)
            cl = CompiledLayer(
                spec=spec, plan=plan, layer_id=lid, kind="pool",
                inp_addr=inp_addr, wgt_addr=-1, bias_addr=-1,
                out_addr=out_addr, inp_layout=inp_layout,
                out_layout=out_layout, out_m=out_m, inp_src=psrc,
                row_groups=((0, ho),), k_groups=((0, spec.c),))
            instrs.append(Instruction(
                Opcode.LOAD_INP, buff_base=0, dram_base=inp_addr,
                size=spec.h * spec.w * spec.c, layer_id=lid))
            instrs.append(Instruction(
                Opcode.POOL, pool_window=spec.window,
                pool_stride=spec.stride, buff_base=0, layer_id=lid))
            instrs.append(Instruction(
                Opcode.SAVE, buff_base=0, dram_base=out_addr,
                layout_out_wino=(out_layout == "wino"), layer_id=lid))
            finish(cl, ho * wo * spec.c)
            continue

        if kind == "fc":
            wgt_addr = bump(spec.d_in * spec.d_out)
            bias_addr = bump(spec.d_out)
            out_addr = alloc_act(spec.d_out)
            cl = CompiledLayer(
                spec=spec, plan=plan, layer_id=lid, kind="fc",
                inp_addr=inp_addr, wgt_addr=wgt_addr, bias_addr=bias_addr,
                out_addr=out_addr, inp_layout=inp_layout,
                out_layout="spat", out_m=0, inp_src=psrc,
                row_groups=((0, 1),), k_groups=((0, spec.d_out),))
            instrs.append(Instruction(
                Opcode.LOAD_BIAS, buff_base=0, dram_base=bias_addr,
                size=spec.d_out, layer_id=lid))
            instrs.append(Instruction(
                Opcode.LOAD_INP, buff_base=0, dram_base=inp_addr,
                size=spec.d_in, layer_id=lid))
            instrs.append(Instruction(
                Opcode.LOAD_WGT, buff_base=0, dram_base=wgt_addr,
                size=spec.d_in * spec.d_out, layer_id=lid))
            instrs.append(Instruction(
                Opcode.FC, buff_base=0, relu_flag=spec.relu,
                size=pack_fc_dims(spec.d_in, spec.d_out), layer_id=lid))
            instrs.append(Instruction(
                Opcode.SAVE, buff_base=0, dram_base=out_addr,
                relu_flag=spec.relu, layer_id=lid))
            finish(cl, spec.d_out)
            continue

        if kind == "eltwise":
            ssrc = spec.skip_from
            check_operand(lid, spec, psrc, "primary operand")
            check_operand(lid, spec, ssrc, "skip operand")
            skip_addr, _, skip_layout = produced[ssrc]
            n_el = spec.h * spec.w * spec.c
            out_addr = alloc_act(n_el)
            cl = CompiledLayer(
                spec=spec, plan=plan, layer_id=lid, kind="eltwise",
                inp_addr=inp_addr, wgt_addr=-1, bias_addr=-1,
                out_addr=out_addr, inp_layout=inp_layout,
                out_layout=out_layout, out_m=out_m,
                inp_src=psrc, skip_src=ssrc, skip_addr=skip_addr,
                skip_layout=skip_layout,
                row_groups=((0, spec.h),), k_groups=((0, spec.c),))
            # two-source block: primary in input slot 0 (tag (lid, 0)),
            # skip in input slot 1 (tag (lid, 1)); the ELTWISE word names
            # both slots in BUFF_BASE and the skip DRAM base in word2 so
            # the stream is a self-checking two-operand read
            instrs.append(Instruction(
                Opcode.LOAD_INP, buff_base=(0 << 1) | 0,
                dram_base=inp_addr, size=n_el, layer_id=lid))
            instrs.append(Instruction(
                Opcode.LOAD_INP, buff_base=(1 << 1) | 1,
                dram_base=skip_addr, size=n_el, layer_id=lid))
            instrs.append(Instruction(
                Opcode.ELTWISE_ADD, buff_base=0 | (1 << 1),
                dram_base=skip_addr, size=n_el,
                relu_flag=spec.relu, layer_id=lid))
            instrs.append(Instruction(
                Opcode.SAVE, buff_base=0, dram_base=out_addr,
                layout_out_wino=(out_layout == "wino"),
                relu_flag=spec.relu, layer_id=lid))
            finish(cl, n_el)
            continue

        if kind == "dw":
            ho, wo = spec.out_hw
            wgt_addr = bump(spec.r * spec.s * spec.c)
            bias_addr = bump(spec.c)
            out_addr = alloc_act(ho * wo * spec.c)
            cl = CompiledLayer(
                spec=spec, plan=plan, layer_id=lid, kind="dw",
                inp_addr=inp_addr, wgt_addr=wgt_addr, bias_addr=bias_addr,
                out_addr=out_addr, inp_layout=inp_layout,
                out_layout=out_layout, out_m=out_m, inp_src=psrc,
                row_groups=((0, ho),), k_groups=((0, spec.c),))
            instrs.append(Instruction(
                Opcode.LOAD_BIAS, buff_base=0, dram_base=bias_addr,
                size=spec.c, layer_id=lid))
            instrs.append(Instruction(
                Opcode.LOAD_INP, buff_base=0, dram_base=inp_addr,
                size=spec.h * spec.w * spec.c, layer_id=lid))
            instrs.append(Instruction(
                Opcode.LOAD_WGT, buff_base=0, dram_base=wgt_addr,
                size=spec.r * spec.s * spec.c, layer_id=lid))
            instrs.append(Instruction(
                Opcode.DEPTHWISE_CONV, buff_base=0,
                size=pack_dw_geom(spec.r, spec.s, spec.stride),
                relu_flag=spec.relu, layer_id=lid))
            instrs.append(Instruction(
                Opcode.SAVE, buff_base=0, dram_base=out_addr,
                layout_out_wino=(out_layout == "wino"),
                relu_flag=spec.relu, layer_id=lid))
            finish(cl, ho * wo * spec.c)
            continue

        ho, wo = spec.out_hw
        wgt_addr = bump(_wgt_words(spec, plan, 0, spec.k))
        bias_addr = bump(spec.k)
        out_addr = alloc_act(ho * wo * spec.k)

        align = plan.m if plan.mode == "wino" else 1
        row_groups = tuple(_split(ho, plan.g_h, align))
        k_groups = tuple(_split(spec.k, plan.g_k))

        cl = CompiledLayer(
            spec=spec, plan=plan, layer_id=lid,
            inp_addr=inp_addr, wgt_addr=wgt_addr, bias_addr=bias_addr,
            out_addr=out_addr, inp_layout=inp_layout, out_layout=out_layout,
            out_m=out_m, inp_src=psrc,
            row_groups=row_groups, k_groups=k_groups)

        wino_f = plan.mode == "wino"
        ws = plan.dataflow == "ws"
        common = dict(wino_flag=wino_f, dataflow_ws=ws, m_tile=plan.m if wino_f else 0,
                      layer_id=lid)

        instrs.append(Instruction(Opcode.LOAD_BIAS, buff_base=0,
                                  dram_base=bias_addr, size=spec.k, **common))

        def li(ih, slot):
            lo, hi = row_groups[ih]
            return Instruction(Opcode.LOAD_INP, buff_base=(ih << 1) | slot,
                               dram_base=inp_addr, size=_inp_words(spec, lo, hi),
                               **common)

        def lw(kg, slot):
            lo, hi = k_groups[kg]
            return Instruction(Opcode.LOAD_WGT, buff_base=(kg << 1) | slot,
                               dram_base=wgt_addr,
                               size=_wgt_words(spec, plan, lo, hi), **common)

        def comp(ih, kg, islot, wslot):
            # SIZE packs (row-group, k-group, buffer slots) for the runtime
            packed = ih | (kg << 12) | (islot << 24) | (wslot << 25)
            return Instruction(Opcode.COMP, buff_base=islot, size=packed,
                               relu_flag=spec.relu, **common)

        def save(ih, kg):
            packed = ih | (kg << 12)
            return Instruction(
                Opcode.SAVE, buff_base=0, dram_base=out_addr, size=packed,
                layout_out_wino=(out_layout == "wino"), relu_flag=spec.relu,
                **common)

        if not ws:  # Input Stationary (Fig. 4 left): inputs outer
            for ih in range(len(row_groups)):
                instrs.append(li(ih, ih % 2))
                for kg in range(len(k_groups)):
                    instrs.append(lw(kg, kg % 2))
                    instrs.append(comp(ih, kg, ih % 2, kg % 2))
                instrs.append(save(ih, 0))   # full-K row slab
        else:       # Weight Stationary: weights outer, inputs re-streamed
            for kg in range(len(k_groups)):
                instrs.append(lw(kg, kg % 2))
                for ih in range(len(row_groups)):
                    instrs.append(li(ih, ih % 2))
                    instrs.append(comp(ih, kg, ih % 2, kg % 2))
                    instrs.append(save(ih, kg))  # (row, K-group) block

        finish(cl, ho * wo * spec.k)

    return Program(instructions=instrs, layers=layers, dram_size_words=alloc)
