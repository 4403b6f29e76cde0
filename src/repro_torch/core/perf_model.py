"""Analytical performance & resource models (paper Sec. 5.1-5.2).

Two backends:

* ``FPGATarget`` — Eq. 3-15 verbatim. This is the *paper-faithful* model; the
  profiling constants (alpha, beta, gamma, delta — "pre-defined through
  profiling" in Sec. 5.1) are calibrated against Table 3/4 so the benchmark
  suite can reproduce the paper's own VU9P / PYNQ-Z1 numbers and the DSE can
  re-derive the paper's chosen configurations (PI=4, PO=4, PT=6, NI=6 on
  VU9P).

* ``TPUTarget`` — the hardware-adapted model. BRAM -> VMEM footprint,
  DSP count -> MXU peak with an alignment-efficiency factor, DDR BW -> HBM BW,
  NI instances -> data-parallel shards. The latency equations keep the
  paper's exact max(compute, load_inp, load_wgt, save) + penalty structure
  (Eq. 12-15); only the rate constants change.

All latencies are in seconds, sizes in bytes unless suffixed ``_words``.

In this package every constant below is a *planning input*: the reference
package's TPU v5e and FPGA models, copied verbatim so that both packages run
the same DSE and compile the same ``Program``. None of them is a measurement,
and none describes the GPU this package executes on.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hybrid_conv import (
    ConvSpec,
    DepthwiseSpec,
    EltwiseSpec,
    FCSpec,
    PoolSpec,
)
from repro_torch.core.winograd import R_WINO, pt_for


# ---------------------------------------------------------------------------
# Hardware targets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FPGATarget:
    """An FPGA device for the verbatim Eq. 3-15 model."""
    name: str
    luts: int
    dsps: int
    bram_18k: int
    freq: float                 # Hz
    bw: float                   # external memory words/s (DATA_WIDTH words)
    data_width: int = 12        # bits (paper: 12-bit fixed)
    bram_width: int = 18        # bits per BRAM instance port
    # profiling constants (Sec. 5.1), calibrated against Table 3
    alpha: float = 4.0          # quantization correction (per-PO m^2 DSPs)
    beta: float = 24.0          # address-generation DSPs
    gamma: float = 124.7        # LUTs per MAC unit (solved from Table 3's
                                # two published LUT points)
    delta: float = 0.04         # LUT correction for the m^2 transform adders
    dsp_per_mac: float = 1.0    # <1 when packing two low-bit MACs per DSP
    n_dies: int = 1             # SLRs: one accelerator instance must fit a
                                # single die (cross-die routing breaks timing,
                                # Sec. 1 — the reason VU9P runs 6 instances)

    def int8_variant(self) -> "FPGATarget":
        """This device's constants under int8 arithmetic: 8-bit words
        (narrower BRAM partitions and 1.5x more words/s through the same
        byte bandwidth) and two packed MACs per DSP slice (the paper's
        Sec. 5.1 low-precision packing, one step further down from 12-bit)
        — so the DSE both *fits bigger PE arrays* and *streams more words*
        when ranking int8 candidates."""
        return dataclasses.replace(
            self, name=f"{self.name}-int8", data_width=8,
            dsp_per_mac=self.dsp_per_mac / 2,
            bw=self.bw * self.data_width / 8)

    def run_dse(self, specs, batch: int = 1, dtype: str = "float32"):
        """Unified ``Target`` entry point (see ``repro_torch.api``): Step 1-3 of
        the paper's DSE for this device. ``batch`` is accepted for signature
        parity with the TPU target — the FPGA latency model is per-image
        (batch parallelism comes from the NI instances). ``dtype="int8"``
        plans against :meth:`int8_variant` with Winograd gated off (the
        U-space transform is fp-only, mirroring the paper's per-layer
        hybrid-mode choice)."""
        from repro_torch.core.dse import run_fpga_dse
        if dtype == "int8":
            return run_fpga_dse(self.int8_variant(), specs, quantized=True)
        if dtype != "float32":
            raise ValueError(f"unsupported DSE dtype {dtype!r}")
        return run_fpga_dse(self, specs)


# bw calibrated against Table 4 (the paper does not publish its DDR4/DDR3
# bandwidths): VU9P 50e9 12-bit words/s ~= 75 GB/s (NSA.241 multi-channel
# DDR4); PYNQ-Z1 0.95e9 ~= 1.4 GB/s (DDR3-1050, 16-bit). With these the DSE
# re-derives the paper's exact configurations and GOPS within 0.2% / 8%.
VU9P = FPGATarget(
    name="VU9P", luts=1182240, dsps=6840, bram_18k=4320,
    freq=167e6, bw=50e9, dsp_per_mac=1.0, n_dies=3)
PYNQ_Z1 = FPGATarget(
    name="PYNQ-Z1", luts=53200, dsps=220, bram_18k=280,
    freq=100e6, bw=0.95e9, dsp_per_mac=0.5)


@dataclasses.dataclass(frozen=True)
class TPUTarget:
    """TPU v5e chip constants (the dry-run/roofline hardware)."""
    name: str = "v5e"
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    ici_bw: float = 50e9                # bytes/s per link
    vmem_bytes: int = 128 * 2 ** 20
    bytes_per_word: int = 2             # bf16
    mxu_dim: int = 128                  # systolic edge; alignment unit
    sublane: int = 8
    vpu_flops: float = 4 * 985e9        # VPU lanes for the Winograd transforms

    def int8_variant(self) -> "TPUTarget":
        """This chip's constants under int8 arithmetic: 1-byte words through
        the memory system and double the MXU MAC rate (int8 ops run at 2x
        the bf16 peak on v5e-class parts) — halves every bandwidth-bound
        term and the compute-bound term alike when ranking int8 plans."""
        return dataclasses.replace(
            self, name=f"{self.name}-int8", bytes_per_word=1,
            peak_flops=2 * self.peak_flops)

    def run_dse(self, specs, batch: int = 1, dtype: str = "float32"):
        """Unified ``Target`` entry point (see ``repro_torch.api``): enumerate GEMM
        block candidates under this chip's VMEM budget and plan per-layer
        (mode, dataflow, m, g_h, g_k) at the given serving batch.
        ``dtype="int8"`` plans against :meth:`int8_variant` with Winograd
        gated off (no int8 U-space transform)."""
        from repro_torch.core.dse import run_tpu_dse
        if dtype == "int8":
            return run_tpu_dse(specs, batch=batch, t=self.int8_variant(),
                               quantized=True)
        if dtype != "float32":
            raise ValueError(f"unsupported DSE dtype {dtype!r}")
        return run_tpu_dse(specs, batch=batch, t=self)


V5E = TPUTarget()


# ---------------------------------------------------------------------------
# FPGA resource model — Eq. 3, 4, 5 verbatim
# ---------------------------------------------------------------------------

def fpga_dsp(t: FPGATarget, pi: int, po: int, pt: int, m: int) -> float:
    """Eq. 3: N_DSP = PI*PO*PT^2 + alpha*PO*m^2 + PO + beta."""
    return (pi * po * pt * pt) * t.dsp_per_mac + t.alpha * po * m * m + po + t.beta


def fpga_bram(t: FPGATarget, pi: int, po: int, pt: int, m: int) -> float:
    """Eq. 4."""
    return (t.data_width / t.bram_width) * (
        pi * pt * pt + pi * po * pt * pt + (1 + t.alpha) * po * m * m)


def fpga_lut(t: FPGATarget, pi: int, po: int, pt: int, m: int) -> float:
    """Eq. 5: N_LUT = gamma * (PI*PO*PT^2) * (1 + delta*m^2)."""
    return t.gamma * (pi * po * pt * pt) * (1 + t.delta * m * m)


def fpga_fits(t: FPGATarget, pi: int, po: int, pt: int, m: int, ni: int) -> bool:
    # one instance must fit within a single die (no cross-die PE routing)
    die = (fpga_dsp(t, pi, po, pt, m) <= t.dsps / t.n_dies
           and fpga_bram(t, pi, po, pt, m) <= t.bram_18k / t.n_dies
           and fpga_lut(t, pi, po, pt, m) <= t.luts / t.n_dies)
    total = (ni * fpga_dsp(t, pi, po, pt, m) <= t.dsps
             and ni * fpga_bram(t, pi, po, pt, m) <= t.bram_18k
             and ni * fpga_lut(t, pi, po, pt, m) <= t.luts)
    return die and total


# ---------------------------------------------------------------------------
# FPGA latency model — Eq. 6-15 verbatim
# ---------------------------------------------------------------------------

def _kernel_groups(spec: ConvSpec) -> int:
    return math.ceil(spec.r / R_WINO) * math.ceil(spec.s / R_WINO)


def fpga_t_cp(t: FPGATarget, s: ConvSpec, pi, po, pt, m, mode: str) -> float:
    ho, wo = s.out_hw
    if mode == "spat":
        # Eq. 6
        return (s.k * s.c * s.r * s.s * ho * wo) / (t.freq * pi * po * pt * pt)
    # Eq. 7
    return (s.k * s.c * _kernel_groups(s) * pt * pt * ho * wo) / (
        t.freq * pi * po * pt * pt * m * m)


def fpga_t_ldw(t: FPGATarget, s: ConvSpec, pi, po, pt, m, mode: str) -> float:
    rate = min(t.bw, t.freq * pi * po * pt)
    if mode == "spat":
        return (s.k * s.c * s.r * s.s) / rate                      # Eq. 8
    return (s.k * s.c * _kernel_groups(s) * pt * pt) / rate        # Eq. 9


def fpga_t_ldi(t: FPGATarget, s: ConvSpec, pi, pt) -> float:
    return (s.c * s.h * s.w) / min(t.bw, t.freq * pi * pt)         # Eq. 10


def fpga_t_sv(t: FPGATarget, s: ConvSpec, po, pt) -> float:
    ho, wo = s.out_hw
    return (s.k * ho * wo) / min(t.bw, t.freq * po * pt)           # Eq. 11


def fpga_pool_latency(t: FPGATarget, s: PoolSpec, pi: int, pt: int) -> float:
    """POOL streams through the LOAD path at the input rate (Eq. 10 analog):
    the comparison tree keeps up with the stream, so the layer is bound by
    reading the input map and writing the decimated output."""
    ho, wo = s.out_hw
    words = s.c * s.h * s.w + s.c * ho * wo
    return words / min(t.bw, t.freq * pi * pt)


def fpga_eltwise_latency(t: FPGATarget, s: EltwiseSpec,
                         pi: int, pt: int) -> float:
    """ELTWISE_ADD streams TWO source fmaps in and one out through the
    LOAD/SAVE datapath (Eq. 10/11 analog); the adder array keeps up with
    the stream, so the layer is pure external-memory traffic."""
    words = 3 * s.h * s.w * s.c
    return words / min(t.bw, t.freq * pi * pt)


def fpga_dw_latency(t: FPGATarget, s: DepthwiseSpec,
                    pi: int, pt: int) -> float:
    """DEPTHWISE_CONV has no output-channel reuse (one filter per channel),
    so only the PI*PT input-parallel lanes apply — the PO dimension of the
    MAC array idles. Latency is max(compute on PI*PT MACs, streaming the
    input + decimated output maps)."""
    ho, wo = s.out_hw
    t_cp = s.macs / (t.freq * pi * pt)
    words = s.h * s.w * s.c + s.r * s.s * s.c + ho * wo * s.c
    t_mem = words / min(t.bw, t.freq * pi * pt)
    return max(t_cp, t_mem)


def fpga_fc_latency(t: FPGATarget, s: FCSpec, pi, po, pt) -> float:
    """FC is a GEMV on the PE's MAC array: every weight word is used once,
    so the layer is the max of compute (Eq. 6 analog with HO*WO = 1) and
    streaming the weight matrix from external memory."""
    t_cp = s.d_in * s.d_out / (t.freq * pi * po * pt)
    t_ldw = s.d_in * s.d_out / t.bw
    return max(t_cp, t_ldw)


def fpga_layer_latency(t: FPGATarget, s: ConvSpec, pi, po, pt, m,
                       mode: str, dataflow: str,
                       g_h: int | None = None, g_k: int | None = None) -> float:
    """Eq. 12-15. g_h defaults to the paper's H (spat) or H/m (wino) groups."""
    ho, _ = s.out_hw
    if g_h is None:
        g_h = ho if mode == "spat" else math.ceil(ho / m)
    if g_k is None:
        g_k = max(1, s.k // po)
    t_cp = fpga_t_cp(t, s, pi, po, pt, m, mode)
    t_ldw = fpga_t_ldw(t, s, pi, po, pt, m, mode)
    t_ldi = fpga_t_ldi(t, s, pi, pt)
    t_sv = fpga_t_sv(t, s, po, pt)
    if dataflow == "is":
        body = max(t_ldi, g_h * t_ldw, t_cp, t_sv)                 # Eq. 12/14
        penalty = t_ldw / max(1, g_k) + t_ldi / max(1, g_h)
    else:
        body = max(g_k * t_ldi, t_ldw, t_cp, t_sv)                 # Eq. 13/15
        penalty = t_ldi / max(1, g_h) + t_ldw / max(1, g_k)
    return body + penalty


# ---------------------------------------------------------------------------
# TPU-adapted model (BRAM->VMEM, DSP->MXU, DDR->HBM)
# ---------------------------------------------------------------------------

def _align_eff(size: int, unit: int) -> float:
    """Fraction of useful work when ``size`` pads up to a multiple of ``unit``."""
    if size <= 0:
        return 1.0
    return size / (math.ceil(size / unit) * unit)


def tpu_mxu_eff(mdim: int, kdim: int, ndim: int, t: TPUTarget = V5E) -> float:
    """MXU alignment efficiency — the Eq. 3 'DSP utilization' analog."""
    return (_align_eff(mdim, t.sublane)
            * _align_eff(kdim, t.mxu_dim)
            * _align_eff(ndim, t.mxu_dim))


def tpu_gemm_dims(s: ConvSpec, mode: str, m: int, batch: int = 1):
    """(G, M, K, N) of the GEMM the PE executes for this layer."""
    ho, wo = s.out_hw
    if mode == "spat":
        return (1, batch * ho * wo, s.c * s.r * s.s, s.k)
    pt = pt_for(m)
    nt = batch * math.ceil(ho / m) * math.ceil(wo / m)
    return (_kernel_groups(s) * pt * pt, nt, s.c, s.k)


def _block_eff(size: int, block: int) -> float:
    """Useful fraction when size pads to a whole number of blocks."""
    if size <= 0:
        return 1.0
    return size / (math.ceil(size / block) * block)


def tpu_t_cp(t: TPUTarget, s: ConvSpec, mode: str, m: int,
             batch: int = 1,
             blocks: tuple[int, int, int] | None = None) -> float:
    """Transformed-domain MACs / (peak * alignment-eff) + VPU transform time.

    ``blocks=(bm, bk, bn)`` folds GEMM block-padding waste into the
    efficiency (a 130-tile M dim on bm=512 runs at 130/512 MXU efficiency) —
    the Eq. 3 'PE size vs layer size' mismatch, TPU-style.
    """
    g, md, kd, nd = tpu_gemm_dims(s, mode, m, batch)
    eff = tpu_mxu_eff(md, kd, nd)
    if blocks is not None:
        bm, bk, bn = blocks
        eff *= (_block_eff(md, bm) * _block_eff(kd, bk) * _block_eff(nd, bn))
    flops = 2.0 * g * md * kd * nd
    t_mxu = flops / (t.peak_flops * eff)
    if mode == "wino":
        pt = pt_for(m)
        # B^T d B + A^T M A: ~2*PT^3*2 flops per tile-channel on the VPU
        ho, wo = s.out_hw
        nt = batch * math.ceil(ho / m) * math.ceil(wo / m)
        t_vpu = (4.0 * pt ** 3 * nt * (s.c + s.k)) / t.vpu_flops
        return max(t_mxu, t_vpu)  # transforms overlap the MXU pipeline
    return t_mxu


def tpu_t_ldw(t: TPUTarget, s: ConvSpec, mode: str, m: int) -> float:
    if mode == "spat":
        words = s.k * s.c * s.r * s.s
    else:
        pt = pt_for(m)
        words = s.k * s.c * _kernel_groups(s) * pt * pt
    return words * t.bytes_per_word / t.hbm_bw


def tpu_t_ldi(t: TPUTarget, s: ConvSpec, batch: int = 1) -> float:
    return batch * s.c * s.h * s.w * t.bytes_per_word / t.hbm_bw


def tpu_t_sv(t: TPUTarget, s: ConvSpec, batch: int = 1) -> float:
    ho, wo = s.out_hw
    return batch * s.k * ho * wo * t.bytes_per_word / t.hbm_bw


def tpu_vmem_footprint(s: ConvSpec, mode: str, m: int,
                       g_h: int, g_k: int, batch: int = 1,
                       t: TPUTarget = V5E) -> int:
    """Bytes of on-chip working set (x2 for ping-pong) — the Eq. 4 analog."""
    ho, wo = s.out_hw
    rows = math.ceil(ho / g_h) + s.r - 1
    inp = batch * rows * s.w * s.c
    if mode == "wino":
        pt = pt_for(m)
        wgt = (s.k // g_k) * s.c * _kernel_groups(s) * pt * pt
    else:
        wgt = (s.k // g_k) * s.c * s.r * s.s
    out = batch * math.ceil(ho / g_h) * wo * (s.k // g_k)
    return 2 * (inp + wgt + out) * t.bytes_per_word


def tpu_layer_latency(t: TPUTarget, s: ConvSpec, mode: str, dataflow: str,
                      m: int = 4, g_h: int = 1, g_k: int = 1,
                      batch: int = 1,
                      blocks: tuple[int, int, int] | None = None) -> float:
    """Eq. 12-15 with TPU rate constants."""
    t_cp = tpu_t_cp(t, s, mode, m, batch, blocks)
    t_ldw = tpu_t_ldw(t, s, mode, m)
    t_ldi = tpu_t_ldi(t, s, batch)
    t_sv = tpu_t_sv(t, s, batch)
    if dataflow == "is":
        body = max(t_ldi, g_h * t_ldw, t_cp, t_sv)
        penalty = t_ldw / max(1, g_k) + t_ldi / max(1, g_h)
    else:
        body = max(g_k * t_ldi, t_ldw, t_cp, t_sv)
        penalty = t_ldi / max(1, g_h) + t_ldw / max(1, g_k)
    return body + penalty


def tpu_pool_latency(t: TPUTarget, s: PoolSpec, batch: int = 1) -> float:
    """POOL on TPU is HBM-bound: read the map, write the decimated map; the
    window-max comparisons run on the VPU and never dominate."""
    ho, wo = s.out_hw
    bytes_ = (batch * s.h * s.w * s.c + batch * ho * wo * s.c) * t.bytes_per_word
    flops = batch * ho * wo * s.c * s.window * s.window
    return max(bytes_ / t.hbm_bw, flops / t.vpu_flops)


def tpu_eltwise_latency(t: TPUTarget, s: EltwiseSpec,
                        batch: int = 1) -> float:
    """ELTWISE_ADD on TPU is HBM-bound: read two fmaps, write one; the
    per-element add runs on the VPU and never dominates."""
    n = batch * s.h * s.w * s.c
    return max(3 * n * t.bytes_per_word / t.hbm_bw, n / t.vpu_flops)


def tpu_dw_latency(t: TPUTarget, s: DepthwiseSpec, batch: int = 1) -> float:
    """DEPTHWISE_CONV on TPU is VPU work (feature_group_count=C defeats the
    MXU's contraction — there is no channel reduction to feed the systolic
    array), bounded below by streaming the maps through HBM."""
    ho, wo = s.out_hw
    flops = 2.0 * batch * s.macs
    bytes_ = (batch * (s.h * s.w + ho * wo) * s.c
              + s.r * s.s * s.c) * t.bytes_per_word
    return max(flops / t.vpu_flops, bytes_ / t.hbm_bw)


def tpu_fc_latency(t: TPUTarget, s: FCSpec, batch: int = 1,
                   blocks: tuple[int, int, int] | None = None) -> float:
    """FC as a (batch, d_in) x (d_in, d_out) GEMM on the MXU.

    At serving batch sizes the MXU runs at batch/sublane-alignment
    efficiency and the layer is usually bound by streaming the weight
    matrix from HBM — the same weight-bandwidth wall Eq. 8/9 models for
    CONV weights on the FPGA.
    """
    eff = tpu_mxu_eff(batch, s.d_in, s.d_out)
    if blocks is not None:
        bm, bk, bn = blocks
        eff *= (_block_eff(batch, bm) * _block_eff(s.d_in, bk)
                * _block_eff(s.d_out, bn))
    flops = 2.0 * batch * s.d_in * s.d_out
    bytes_ = (s.d_in * s.d_out
              + batch * (s.d_in + s.d_out)) * t.bytes_per_word
    return max(flops / (t.peak_flops * eff), bytes_ / t.hbm_bw)


def layer_gops(s: ConvSpec, latency: float, batch: int = 1) -> float:
    """Effective GOPS: *algorithmic* ops (2*MACs of the direct conv) per
    second — the paper counts Winograd speedups this way (Table 4)."""
    return 2.0 * batch * s.macs / latency / 1e9


def tpu_layer_latency_xla_ref(t: TPUTarget, s: ConvSpec, mode: str,
                              m: int = 4, batch: int = 1) -> float:
    """Latency model of the UNFUSED (XLA-reference) implementation variant.

    The fused Pallas kernel keeps Winograd transforms VMEM-resident;
    the XLA reference materializes tiles, V = B^T d B, the PT^2 GEMM output
    M, and the inverse transform in HBM. This variant models that traffic —
    it is what ``bench_model_error`` compiles and validates against, exactly
    as the paper validates its model against its implementation.
    """
    ho, wo = s.out_hw
    bpw = t.bytes_per_word
    g, md, kd, nd = tpu_gemm_dims(s, mode, m, batch)
    flops = 2.0 * g * md * kd * nd
    x_b = batch * s.h * s.w * s.c
    w_b = s.k * s.c * s.r * s.s
    y_b = batch * ho * wo * s.k
    if mode == "spat":
        patches = md * kd                    # im2col matrix (T, C*R*S)
        bytes_ = (x_b + patches * 2 + w_b + y_b) * bpw
    else:
        pt = pt_for(m)
        nt = md                              # tiles
        tiles = nt * pt * pt * s.c
        v = g * nt * s.c                     # PT^2 * T * C
        u = g * s.c * s.k
        mm = g * nt * s.k
        bytes_ = (x_b + tiles + 2 * v + u + 2 * mm + y_b) * bpw
        # VPU transform flops
        flops += 4.0 * pt ** 3 * nt * (s.c + s.k)
    return max(flops / t.peak_flops, bytes_ / t.hbm_bw)
