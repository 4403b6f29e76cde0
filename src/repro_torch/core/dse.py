"""Design Space Exploration (paper Sec. 5.3, Table 2).

The 3-step algorithm:

  Step (1)  enumerate hardware-parameter candidates. FPGA: for each
            PT in {4, 6}, grow PI, PO, NI until a resource constraint
            (Eq. 3-5) breaks, keeping PI >= PO >= 1. TPU: enumerate GEMM
            block shapes (bm, bk, bn) and Winograd m under the VMEM
            footprint constraint — the BRAM/DSP analog.
  Step (2)  for each candidate, pick per-layer SW parameters
            (mode_l in {spat, wino}, dataflow_l in {is, ws}) by evaluating
            the latency model (Eq. 12-15) — O(N*L).
  Step (3)  select argmin_candidates sum_l T_l — O(N).

Returns the winning HW candidate plus per-layer ``LayerPlan``s directly
consumable by ``core/compiler.compile_network``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import perf_model as pm
from repro_torch.core.compiler import NO_PLAN, LayerPlan
from repro_torch.core.hybrid_conv import (ConvSpec, DepthwiseSpec, EltwiseSpec,
                                    FCSpec, PoolSpec)
from repro_torch.core.winograd import pt_for


class DSEError(ValueError):
    """No feasible hardware candidate (or nothing to plan).

    Raised instead of silently returning ``None`` when Step (1) produces an
    empty candidate list — e.g. a resource budget too small for even the
    minimum PE, or a ``vmem_bytes`` below the smallest block working set.
    """


# ---------------------------------------------------------------------------
# FPGA DSE (paper-faithful)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FPGACandidate:
    pi: int
    po: int
    pt: int
    ni: int

    @property
    def m(self) -> int:
        return self.pt - 2


@dataclasses.dataclass
class DSEResult:
    hw: object
    plans: list[LayerPlan]
    layer_latencies: list[float]
    total_latency: float
    candidates_searched: int


def enumerate_fpga_candidates(t: pm.FPGATarget,
                              max_factor: int = 64) -> list[FPGACandidate]:
    """Step (1): grow PI, PO, NI for each PT until resources break."""
    cands = []
    for pt in (4, 6):
        m = pt - 2
        for ni in (1, 2, 3, 4, 6, 8):
            best = None
            pi = po = 1
            while True:
                grown = False
                # take turns increasing PI then PO (keeping PI >= PO)
                for attr in ("pi", "po"):
                    np_, nq = (pi * 2, po) if attr == "pi" else (pi, po * 2)
                    if np_ >= nq and np_ <= max_factor and nq <= max_factor \
                            and pm.fpga_fits(t, np_, nq, pt, m, ni):
                        pi, po = np_, nq
                        grown = True
                if not grown:
                    break
            if pm.fpga_fits(t, pi, po, pt, m, ni):
                best = FPGACandidate(pi, po, pt, ni)
            if best:
                cands.append(best)
    # canonicalize: the candidate stream must be duplicate-free however the
    # grow strategy evolves (today it appends at most one candidate per
    # (PT, NI) pair, so this is a guarded invariant, not a repair)
    return list(dict.fromkeys(cands))


def _fpga_layer_best(t: pm.FPGATarget, cand: FPGACandidate,
                     spec: ConvSpec,
                     allow_wino: bool = True) -> tuple[LayerPlan, float]:
    """Step (2): best (mode, dataflow) for one layer under one candidate.
    ``allow_wino=False`` restricts the search to spatial plans — the
    quantized PE has no int8 U-space transform, so int8 DSE must not rank
    (let alone pick) Winograd candidates it cannot execute."""
    best = None
    for mode in ("spat", "wino"):
        if mode == "wino" and not (allow_wino and spec.wino_eligible(cand.m)):
            continue
        for dataflow in ("is", "ws"):
            lat = pm.fpga_layer_latency(t, spec, cand.pi, cand.po, cand.pt,
                                        cand.m, mode, dataflow)
            if best is None or lat < best[1]:
                best = (LayerPlan(mode=mode, dataflow=dataflow, m=cand.m), lat)
    return best


LayerSpec = ConvSpec | PoolSpec | FCSpec | EltwiseSpec | DepthwiseSpec


def run_fpga_dse(t: pm.FPGATarget,
                 specs: Sequence[LayerSpec],
                 quantized: bool = False) -> DSEResult:
    if not specs:
        raise DSEError("FPGA DSE: empty layer list — nothing to plan")
    cands = enumerate_fpga_candidates(t)
    if not cands:
        raise DSEError(
            f"FPGA DSE: no hardware candidate fits {t.name} "
            f"(LUT={t.luts}, DSP={t.dsps}, BRAM18K={t.bram_18k}, "
            f"dies={t.n_dies}) — even the minimum PE (PI=PO=1, PT=4, NI=1) "
            f"exceeds the Eq. 3-5 resource budget")
    best_result = None
    for cand in cands:
        # NI instances process different images but SHARE the DRAM port
        t_inst = dataclasses.replace(t, bw=t.bw / cand.ni)
        plans, lats = [], []
        for spec in specs:
            # POOL/FC have no DSE-searchable software parameters; they
            # still contribute latency so candidates rank on the FULL net
            if isinstance(spec, PoolSpec):
                plan, lat = NO_PLAN, pm.fpga_pool_latency(
                    t_inst, spec, cand.pi, cand.pt)
            elif isinstance(spec, FCSpec):
                plan, lat = NO_PLAN, pm.fpga_fc_latency(
                    t_inst, spec, cand.pi, cand.po, cand.pt)
            elif isinstance(spec, EltwiseSpec):
                plan, lat = NO_PLAN, pm.fpga_eltwise_latency(
                    t_inst, spec, cand.pi, cand.pt)
            elif isinstance(spec, DepthwiseSpec):
                plan, lat = NO_PLAN, pm.fpga_dw_latency(
                    t_inst, spec, cand.pi, cand.pt)
            else:
                plan, lat = _fpga_layer_best(t_inst, cand, spec,
                                             allow_wino=not quantized)
            plans.append(plan)
            lats.append(lat / cand.ni)  # throughput: NI images in flight
        total = sum(lats)
        if best_result is None or total < best_result.total_latency:
            best_result = DSEResult(cand, plans, lats, total, len(cands))
    return best_result


# ---------------------------------------------------------------------------
# TPU DSE (hardware-adapted)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPUCandidate:
    bm: int            # GEMM block shapes — the PI/PO/PT analog
    bk: int
    bn: int
    m: int             # Winograd output tile (PT = m + 2)


def enumerate_tpu_candidates(t: pm.TPUTarget = pm.V5E) -> list[TPUCandidate]:
    """Step (1): block shapes growing by 2x until the VMEM working set
    (bm*bk + bk*bn + bm*bn fp32 words, x2 double-buffered) no longer fits."""
    cands = []
    for m in (2, 4):
        for bm in (128, 256, 512, 1024):
            for bk in (128, 256, 512, 1024):
                for bn in (128, 256, 512, 1024):
                    working = 4 * 2 * (bm * bk + bk * bn + bm * bn)
                    if working <= t.vmem_bytes // 2:  # margin for transforms
                        cands.append(TPUCandidate(bm, bk, bn, m))
    return cands


def _tpu_groups(spec: ConvSpec, mode: str, m: int, batch: int,
                t: pm.TPUTarget) -> tuple[int, int]:
    """Smallest (g_h, g_k) whose working set fits VMEM (Eq. 4 analog)."""
    ho, _ = spec.out_hw
    for g_h in (1, 2, 4, 8, 16):
        for g_k in (1, 2, 4, 8):
            if g_h > ho or g_k > spec.k:
                continue
            if pm.tpu_vmem_footprint(spec, mode, m, g_h, g_k, batch, t) \
                    <= t.vmem_bytes:
                return g_h, g_k
    return 16, 8


def _tpu_layer_best(t: pm.TPUTarget, cand: TPUCandidate, spec: ConvSpec,
                    batch: int,
                    allow_wino: bool = True) -> tuple[LayerPlan, float]:
    best = None
    for mode in ("spat", "wino"):
        if mode == "wino" and not (allow_wino and spec.wino_eligible(cand.m)):
            continue
        g_h, g_k = _tpu_groups(spec, mode, cand.m, batch, t)
        for dataflow in ("is", "ws"):
            lat = pm.tpu_layer_latency(t, spec, mode, dataflow, cand.m,
                                       g_h, g_k, batch,
                                       blocks=(cand.bm, cand.bk, cand.bn))
            if best is None or lat < best[1]:
                best = (LayerPlan(mode=mode, dataflow=dataflow, m=cand.m,
                                  g_h=g_h, g_k=g_k), lat)
    return best


def run_tpu_dse(specs: Sequence[LayerSpec], batch: int = 1,
                t: pm.TPUTarget = pm.V5E,
                quantized: bool = False) -> DSEResult:
    if not specs:
        raise DSEError("TPU DSE: empty layer list — nothing to plan")
    cands = enumerate_tpu_candidates(t)
    if not cands:
        raise DSEError(
            f"TPU DSE: no (bm, bk, bn) block shape fits {t.name}'s VMEM "
            f"budget ({t.vmem_bytes} bytes) — the smallest double-buffered "
            f"working set (bm=bk=bn=128) needs "
            f"{2 * 4 * 2 * (3 * 128 * 128)} bytes")
    best_result = None
    for cand in cands:
        plans, lats = [], []
        for spec in specs:
            if isinstance(spec, PoolSpec):
                plan, lat = NO_PLAN, pm.tpu_pool_latency(t, spec, batch)
            elif isinstance(spec, FCSpec):
                plan, lat = NO_PLAN, pm.tpu_fc_latency(
                    t, spec, batch, blocks=(cand.bm, cand.bk, cand.bn))
            elif isinstance(spec, EltwiseSpec):
                plan, lat = NO_PLAN, pm.tpu_eltwise_latency(t, spec, batch)
            elif isinstance(spec, DepthwiseSpec):
                plan, lat = NO_PLAN, pm.tpu_dw_latency(t, spec, batch)
            else:
                plan, lat = _tpu_layer_best(t, cand, spec, batch,
                                            allow_wino=not quantized)
            plans.append(plan)
            lats.append(lat)
        total = sum(lats)
        if best_result is None or total < best_result.total_latency:
            best_result = DSEResult(cand, plans, lats, total, len(cands))
    return best_result
