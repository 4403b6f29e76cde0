"""Chip smoke test: the PyTorch port's main paths on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version at every shape the main paths
give it (fp32 within ``1e-4 * max(1, max|ref|)``, K5 bit for bit, K6 in
bf16 element by element within ``2**-7 * |ref| + 1e-6``, one bf16 step;
K1/K2 must take the tensor-core route, 3xTF32, at every call with M >= 64
and K, N multiples of 4, and K5 its int8 tensor-core route, ``tc_s8``, at
every call with M >= 64 and K, N multiples of 16; K3/K4 through their
NHWC fronts at the geometry the executor gives them, on the float4 route
wherever the channels come in fours, and off the paths through the tiles
fronts, at m = 2 and at a ragged geometry; and times kernel, plain version
and the nearest single PyTorch call),
then serves six CNN paths through ``repro_torch.api.Accelerator`` with
``backend="hopper"``, batch 8, ``pm.V5E`` plans:

* VGG16, 224x224, 1000 classes, fp32 (K1-K4);
* the same VGG16 in int8, default calibration (K5);
* ResNet-18 at full width, ``resnet18_specs(128, 1, n_classes=1000)``, fp32
  (K1-K4) and int8 (K5);
* the reference's depthwise chain (conv -> depthwise -> depthwise,
  stride 2 -> pool -> FC, ``tests/test_residual_ops.py``) at 56x56x128,
  fp32 (K1, K2) and int8 (K5): a check input for DEPTHWISE_CONV, also held
  to the same program on the CPU (fp32 within ``1e-3 * max|logit|``, int8
  bit for bit), since both backends share the depthwise op;

then serves the four model paths (VGG16 and ResNet-18, fp32 and int8)
through a ``ServingSession`` over the same accelerators (phase 3b):
``acc.serve(max_batch=8, warmup=True)``, a bulk ``run_many`` of 16
requests of 8 images (each bit for bit ``acc(x)`` on the same batch), then
two windows of 4096 single images arriving open-loop, at 80 % of the direct
path's images/s and at 80 % of what the session sustained (the lower of
its bulk rate and the first window's served rate; each held to its row of
``acc(x)``: int8 bit for bit, fp32 within
``1e-3 * max|logit|``; the served rate beside the offered one, and no
latency percentile where the session fell behind), every session ending
with ``errors == 0``, no retry, ``submitted == requests + errors + shed``,
its launch counts the per-request launches times its batches; on
ResNet-18 fp32 a one-shot ``execute`` error in the middle of a ``run_many``
stream (bisected on hopper, every result bit for bit ``acc(x)``), one
cursed request (``isolated == 1``, innocents bit for bit) and three
concurrent ``run_many`` callers (bit for bit ``acc(x)``);
``save_program`` / ``from_program`` of VGG16 int8 and ResNet-18 fp32 (bit
for bit) and VGG16's ``summary()``; and VGG16 fp32 ``segmented=True`` (5
segment Programs, host maxpool, FC tail on K2; launches per request and
logits equal to the single Program's);

then, on each of the six, the strict per-instruction interpreter
(``HybridRuntime(strict=True, backend="hopper")`` on the served program,
params and sidecar: one kernel call per COMP block and per FC), held bit
for bit to an ``opt_level=0`` hopper executor on the same DRAM image, and
to the served path (int8 bit for bit, fp32 within ``1e-3 * max|logit|``),
with one request of each under ``torch.profiler``; and a last path through
``repro_torch.launch.serve.serve`` with ``backend="hopper"``:

* full-width minitron-8b in bf16 (32 layers, d_model 4096, vocab 256000,
  random weights from seed 0), batch 2, a 4096-token prompt, 16 greedy
  tokens: K6 once per layer of the prefill, never in a decode step.

Each CNN path answers one first request and several steady ones, with the
launch counts set to 0 just before it and checked per request just after,
and its logits held against the ``backend="torch"`` (aten) path on the same
card: fp32 within ``1e-3 * max|logit|``, int8 bit for bit with the same
params and sidecar. The LM path's launches are counted the same way around
its one served request (and per phase in a second prefill and one decode
step), and its last-token prefill logits are held against
``backend="torch"`` (the scan-flash attention, which rounds P to bf16)
within ``5e-2 * max|logit|``. Any failure raises and exits non-zero;
without a CUDA card, or without the repository beside it, the script exits
non-zero before printing any result.

Phase 2 also holds every kernel at the shapes of the interpreter's calls
(``*_strict`` paths: per COMP block, the block's rows and k-group); the
summary's times sum the four CNN model paths and the LM path only, its
launches every counted request of the run.

Output: the card's name and power limit, one JSON line per (kernel, layer)
(for K1-K5 with its ``route``; for K1/K2 its bound at three TF32
products per product, and ``fma_bound_ms``, the bound on the fp32 FMA
pipes),
the timings of each path (for the interpreter, its requests beside the
served and ``opt_level=0`` executors', and the kernels whose device time
differs most between the two under the profiler; for the LM also a
``torch.profiler`` breakdown of one prefill and one decode step: device
busy time and the longest kernels), a ``{"kernels": [...]}`` summary
line, and as the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32, bf16 and int8 on the tensor cores, and HBM3 bandwidth;
# they assume the 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
BATCH, N_CLASSES = 8, 1000
STEADY_REQUESTS = 10
KERNEL_REPS = 10
# per-request launches on each main path, from its program (pm.V5E plans,
# batch 8, opt_level 1: one dispatch per layer)
PATHS = {
    # 9 Spatial CONVs (K1); 4 Winograd GEMMs + 3 FC (K2); 4 Winograd CONVs
    "vgg16_fp32": {"conv_gemm_f32": 9, "bmm_f32": 7,
                   "wino_input_transform_f32": 4,
                   "wino_output_transform_f32": 4},
    # 13 CONVs + 3 FC, all Spatial under the int8 DSE
    "vgg16_int8": {"qmm_i8": 16},
    # 16 Spatial CONVs (K1); 4 Winograd GEMMs + 1 FC (K2); 4 Winograd CONVs
    "resnet18_fp32": {"conv_gemm_f32": 16, "bmm_f32": 5,
                      "wino_input_transform_f32": 4,
                      "wino_output_transform_f32": 4},
    # 20 CONVs + 1 FC
    "resnet18_int8": {"qmm_i8": 21},
    # the reference's depthwise chain (tests/test_residual_ops.py) at
    # 56x56x128, a check input for DEPTHWISE_CONV: one Spatial CONV and the
    # FC on the PE, the two depthwise layers in aten
    "dwchain_fp32": {"conv_gemm_f32": 1, "bmm_f32": 1},
    "dwchain_int8": {"qmm_i8": 2},
    # one K6 per layer of the prefill (prompt >= 2048 tokens); a decode
    # step attends one token through the einsum branch
    "minitron8b_bf16": {"flash_attention": 32},
}
LM_PATH = "minitron8b_bf16"
# kept out of the summary's times, which sum the model paths
DW_PATHS = ("dwchain_fp32", "dwchain_int8")
# phase 4: the strict interpreter on each CNN path, with its own launch
# counts and kernel shapes (phase 2): one PE call per COMP block and per
# FC, the opt_level=0 executor's calls
STRICT_PATHS = {f"{p}_strict": p for p in PATHS if p != LM_PATH}
# phase 3b: the four model paths through a ServingSession (max_batch 8):
# a bulk run of 16 requests of 8 images, then two windows of 4096 single
# images (the session's whole latency window; 3-7 s at these rates)
# arriving at 80 % of the direct path's images/s and at 80 % of what the
# session sustained (the lower of the bulk rate and the first window's
# served rate). A session that keeps up loses only its last request's
# latency from the served rate (under 1 % of a 3 s window); a window
# served below OVERLOAD of its offered rate ended with over 2 % of it
# queued, is overloaded and reports no latency percentile
SESSION_PATHS = ("vgg16_fp32", "vgg16_int8", "resnet18_fp32",
                 "resnet18_int8")
SESSION_BULK, SESSION_ARRIVALS, SESSION_LOAD, OVERLOAD = 16, 4096, 0.8, 0.98
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "minitron-8b", 2, 4096, 16
# hopper vs torch last-token prefill logits, relative to max|logit|: K6
# keeps P in fp32 where the scan rounds it to bf16, over 32 layers
LM_TOL = 5e-2
# K6 in bf16 against its plain version, element by element: both compute
# in fp32 and round once to bf16, so they differ by at most one bf16 step
# (2**-7 of |ref|); the absolute term covers outputs near 0
BF16_STEP, BF16_ABS = 2.0 ** -7, 1e-6
SOURCES = {
    "conv_gemm_f32": ("src/repro_torch/csrc/gemm_f32.cu",
                      "src/repro/kernels/spatial_conv/kernel.py:51"),
    "bmm_f32": ("src/repro_torch/csrc/gemm_f32.cu",
                "src/repro/kernels/gemm/kernel.py:68"),
    "wino_input_transform_f32": ("src/repro_torch/csrc/winograd_f32.cu",
                                 "src/repro/kernels/winograd/kernel.py:52"),
    "wino_output_transform_f32": ("src/repro_torch/csrc/winograd_f32.cu",
                                  "src/repro/kernels/winograd/kernel.py:82"),
    "qmm_i8": ("src/repro_torch/csrc/gemm_i8.cu",
               "src/repro/kernels/gemm/int8.py:60"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:63"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its template
    arguments, registers per thread and spilled bytes."""
    out, name, spill = [], None, "?"
    for line in log.splitlines():
        if m := re.search(r"entry function '(\w+)'", line):
            mangled = m.group(1)
            base = re.search(r"(gemm_f32_kernel|gemm_tc_kernel|"
                             r"qmm_splitk_reduce_kernel|splitk_reduce_kernel|"
                             r"wino_input_vec_kernel|wino_input_scalar_kernel|"
                             r"wino_output_vec_kernel|"
                             r"wino_output_scalar_kernel|"
                             r"qmm_i8_kernel|qmm_tc_kernel|"
                             r"transpose_i8_kernel|"
                             r"flash_attention_f32_kernel|"
                             r"flash_attention_bf16_kernel)", mangled)
            args = [a or b for a, b in re.findall(r"Li(\d+)E|Lb(\d)E",
                                                   mangled)]
            if "bfloat16" in mangled:
                args.insert(0, "bf16")
            name = (base.group(1) if base else mangled) + (
                f"<{','.join(args)}>" if args else "")
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       f"spilled")
            name, spill = None, "?"
    return out


def ptxas_warnings(log: str) -> list[str]:
    """``nvcc``'s warnings about the build, such as ptxas serializing the
    wgmma of a kernel (which costs the tensor cores their overlap)."""
    return [line.strip() for line in log.splitlines()
            if "warning" in line.lower() or "performance loss" in line.lower()]


def time_ms(fn, reps: int = KERNEL_REPS) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float, peak_ops: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def pe_calls(program, per_block: bool):
    """The PE dispatches of one request: ``(layer, label, rows, k)`` per
    CONV layer (the fused lowering, ``opt_level=1``) or, with
    ``per_block``, per COMP block (the strict interpreter and the
    ``opt_level=0`` executor: the block's output rows and k-group width);
    ``rows`` and ``k`` are None for an FC layer."""
    from repro_torch.core.isa import Opcode
    calls = []
    if not per_block:
        for cl in program.layers:
            if cl.kind == "conv":
                calls.append((cl, cl.spec.name, cl.spec.out_hw[0],
                              cl.spec.k))
            elif cl.kind == "fc":
                calls.append((cl, cl.spec.name, None, None))
        return calls
    for ins in program.instructions:
        cl = program.layers[ins.layer_id]
        if ins.opcode == Opcode.COMP:
            ih, kg = ins.size & 0xFFF, (ins.size >> 12) & 0xFFF
            (r0, r1), (lo, hi) = cl.row_groups[ih], cl.k_groups[kg]
            calls.append((cl, f"{cl.spec.name}[{ih},{kg}]", r1 - r0,
                          hi - lo))
        elif ins.opcode == Opcode.FC:
            calls.append((cl, cl.spec.name, None, None))
    return calls


def kernel_cases(program, batch: int, dtype: str, per_block: bool = False):
    """Every kernel call a path makes per request, with its shapes:
    ``(kernel, label, shape dict, launches)``, one entry per PE dispatch
    (:func:`pe_calls`)."""
    from repro_torch.core.executor import width_pad
    from repro_torch.core.winograd import pt_for
    from repro_torch.kernels.common import cdiv
    cases = []
    for cl, label, rows, k in pe_calls(program, per_block):
        s = cl.spec
        if dtype == "int8" and cl.kind == "fc":
            cases.append(("qmm_i8", label, dict(m=batch, k=s.d_in,
                                                n=s.d_out), 1))
        elif dtype == "int8":
            wo = s.out_hw[1]
            cases.append(("qmm_i8", label, dict(
                m=batch * rows * wo, k=s.r * s.s * s.c, n=k), 1))
        elif cl.kind == "fc":
            cases.append(("bmm_f32", label, dict(
                g=1, m=batch, k=s.d_in, n=s.d_out, df="is"), 1))
        elif cl.plan.mode == "spat":
            wo = s.out_hw[1]
            cases.append(("conv_gemm_f32", label, dict(
                t=batch * rows * wo, crs=s.r * s.s * s.c, k=k,
                df=cl.plan.dataflow), 1))
        else:
            # K3 reads the executor's slab (the vertical pad materialized,
            # rows + 2) with the width pad as geometry; K4 writes the
            # (N, rows, Wo, k) block
            m = cl.plan.m
            wo = s.out_hw[1]
            t = batch * cdiv(rows, m) * cdiv(wo, m)
            pt2 = pt_for(m) ** 2
            cases.append(("wino_input_transform_f32", label, dict(
                n=batch, h=rows + 2, w=s.w, c=s.c, m=m,
                pad=((0, 0), width_pad(cl))), 1))
            cases.append(("bmm_f32", label, dict(
                g=pt2, m=t, k=s.c, n=k, df=cl.plan.dataflow), 1))
            cases.append(("wino_output_transform_f32", label, dict(
                n=batch, ho=rows, wo=wo, k=k, m=m), 1))
    return cases


def case_launches(cases) -> dict:
    """Launches per request of each kernel in ``cases``."""
    counted = {}
    for name, _, _, n in cases:
        counted[name] = counted.get(name, 0) + n
    return counted


def wino_offpath_cases():
    """K3/K4 off the main paths (launches 0): the reference's tiles-layout
    fronts at ResNet-18's s1 shape (batch 8 at 64x64: 2048 tiles of 64
    channels), the NHWC fronts at m = 2 on the same layer, and a ragged
    geometry (Ho, Wo not multiples of m, C = K = 5, odd pads: the scalar
    route)."""
    s1 = dict(n=BATCH, h=66, w=64, c=64, m=4, pad=((0, 0), (1, 1)))
    ragged = dict(n=2, h=13, w=11, c=5, m=4, pad=((1, 2), (0, 1)))
    return [
        ("wino_input_transform_f32", "s1_tiles",
         dict(layout="tiles", t=2048, c=64, m=4), 0),
        ("wino_output_transform_f32", "s1_tiles",
         dict(layout="tiles", t=2048, k=64, m=4), 0),
        ("wino_input_transform_f32", "s1_m2", dict(s1, m=2), 0),
        ("wino_output_transform_f32", "s1_m2",
         dict(n=BATCH, ho=64, wo=64, k=64, m=2), 0),
        ("wino_input_transform_f32", "ragged", ragged, 0),
        ("wino_output_transform_f32", "ragged",
         dict(n=2, ho=14, wo=10, k=5, m=4), 0),
    ]


def lm_kernel_cases():
    """K6's calls per request on the LM path (the prefill's shape, once per
    layer) and four shapes off the path (launches 0): the prefill's shape
    in fp32, a chunk of half the prompt at row offset 2048 over the same
    cache (chunked prefill), ragged non-causal fp32, and ragged causal bf16
    with Sq < Skv."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    prefill = dict(b=LM_BATCH, h=cfg.n_heads, hkv=cfg.n_kv_heads,
                   sq=LM_PROMPT, skv=LM_PROMPT + LM_GEN, d=cfg.head_dim,
                   dtype="bf16", causal=True)
    return [
        ("flash_attention", "prefill", prefill, cfg.n_layers),
        ("flash_attention", "prefill_fp32", dict(prefill, dtype="fp32"), 0),
        ("flash_attention", "prefill_chunk", dict(
            prefill, sq=LM_PROMPT // 2, row_offset=LM_PROMPT // 2), 0),
        ("flash_attention", "ragged_fp32", dict(
            b=1, h=4, hkv=2, sq=333, skv=517, d=64, dtype="fp32",
            causal=False), 0),
        ("flash_attention", "ragged_bf16", dict(
            b=2, h=8, hkv=2, sq=100, skv=230, d=128, dtype="bf16",
            causal=True), 0),
    ]


def int_mm_padded(a: torch.Tensor, b: torch.Tensor):
    """``torch._int_mm`` on zero-padded copies (cuBLASLt wants M > 16 and
    K, N multiples of 8; zero padding is exact under zero point 0): a
    yardstick for the product alone, without the epilogue."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 32), -(-k // 8) * 8, -(-n // 8) * 8
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
    bp = torch.zeros((kp, np_), dtype=torch.int8, device=b.device)
    ap[:m, :k] = a
    bp[:k, :n] = b
    return lambda: torch._int_mm(ap, bp)


def run_case(name: str, shape: dict, gen: torch.Generator) -> dict:
    """Kernel vs plain version on the card at one shape; times all three."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.gemm.int8 import qmm_i8, qmm_ref
    from repro_torch.kernels.gemm.kernel import bmm_f32, bmm_ref
    from repro_torch.kernels.spatial_conv.kernel import (
        conv_gemm_f32,
        conv_gemm_ref,
    )
    from repro_torch.core.winograd import tile_input, transform_matrices
    from repro_torch.kernels.winograd.kernel import (
        wino_input_transform_f32,
        wino_input_transform_nhwc_f32,
        wino_input_transform_nhwc_ref,
        wino_input_transform_ref,
        wino_output_transform_f32,
        wino_output_transform_nhwc_f32,
        wino_output_transform_nhwc_ref,
        wino_output_transform_ref,
    )

    def rnd(*size):
        return torch.randn(*size, generator=gen, device="cuda")

    lib, peak, exact, rel = None, PEAK_FP32_FLOPS, False, 1e-4
    elementwise = False
    extra = {}
    gemm = None      # (M, K, N) of a K1/K2/K5 call
    if name == "flash_attention":
        b, h, hkv, sq, skv, d = (shape[x] for x in
                                 ("b", "h", "hkv", "sq", "skv", "d"))
        causal, off = shape["causal"], shape.get("row_offset", 0)
        dt = torch.bfloat16 if shape["dtype"] == "bf16" else torch.float32
        q = rnd(b, h, sq, d).to(dt)
        k, v = rnd(b, hkv, skv, d).to(dt), rnd(b, hkv, skv, d).to(dt)
        qf, kf, vf = (t.view(-1, t.shape[2], d) for t in (q, k, v))
        kern = lambda: flash_attention_kernel(qf, kf, vf, causal=causal,
                                              row_offset=off)
        plain = lambda: flash_attention_ref(qf, kf, vf, causal=causal,
                                            row_offset=off)
        # the yardstick only: SDPA's is_causal is aligned at the top left
        # too; a row offset takes an explicit mask
        mask = None
        if causal and off:
            mask = (torch.arange(skv, device="cuda")[None, :]
                    <= off + torch.arange(sq, device="cuda")[:, None])
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=h != hkv)
        # 4 D operations (QK^T and PV, a multiply-add each) per unmasked
        # (row, col) pair; each of Q, K, V, O moved once
        pairs = (sum(min(i + 1 + off, skv) for i in range(sq)) if causal
                 else sq * skv)
        ops = 4.0 * d * pairs * b * h
        nbytes = q.element_size() * (2.0 * b * h * sq * d
                                     + 2.0 * b * hkv * skv * d)
        if dt == torch.bfloat16:
            peak, elementwise = PEAK_BF16_FLOPS, True
        extra["library_max_abs_diff"] = float(
            (kern().view(b, h, sq, d).float() - lib().float()).abs().max())
    elif name == "qmm_i8":
        m, k, n = shape["m"], shape["k"], shape["n"]
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=gen)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                          generator=gen)
        bias = torch.randint(-20000, 20000, (n,), dtype=torch.int32,
                             device="cuda", generator=gen)
        # multipliers that spread the int32 sums over the int8 range
        mult = (torch.rand(n, generator=gen, device="cuda") + 0.5) / (
            127.0 * k ** 0.5)
        kern = lambda: qmm_i8(a, b, bias, mult, True)
        plain = lambda: qmm_ref(a, b, bias, mult, True)
        lib = int_mm_padded(a, b)            # the product alone
        ops, peak, exact = 2.0 * m * k * n, PEAK_INT8_OPS, True
        nbytes = m * k + k * n + m * n + 8.0 * n
        gemm = (m, k, n)
    elif name == "conv_gemm_f32":
        t, crs, k, df = shape["t"], shape["crs"], shape["k"], shape["df"]
        p, w, b = rnd(t, crs), rnd(crs, k), rnd(k)
        kern = lambda: conv_gemm_f32(p, w, b, True, df)
        plain = lambda: conv_gemm_ref(p, w, b, True, df)
        lib = lambda: torch.addmm(b, p, w)   # bias + GEMM (ReLU not fused)
        ops = 2.0 * t * crs * k
        nbytes = 4.0 * (t * crs + crs * k + k + t * k)
        gemm = (t, crs, k)
    elif name == "bmm_f32":
        g, m, k, n, df = (shape[x] for x in ("g", "m", "k", "n", "df"))
        a, bm = rnd(g, m, k), rnd(g, k, n)
        kern = lambda: bmm_f32(a, bm, None, False, df)
        plain = lambda: bmm_ref(a, bm, None, False, df)
        lib = lambda: torch.bmm(a, bm)
        ops = 2.0 * g * m * k * n
        nbytes = 4.0 * (g * m * k + g * k * n + g * m * n)
        gemm = (m, k, n)
    elif name == "wino_input_transform_f32":
        c, m = shape["c"], shape["m"]
        pt = m + 2
        bt = torch.from_numpy(transform_matrices(m)[0]).cuda()
        if shape.get("layout") == "tiles":
            t = shape["t"]
            tiles = rnd(t, pt, pt, c)
            kern = lambda: wino_input_transform_f32(tiles, m)
            plain = lambda: wino_input_transform_ref(tiles, m)
            in_floats = t * pt * pt * c
        else:
            # x read once, V written once
            n, h, w, pad = shape["n"], shape["h"], shape["w"], shape["pad"]
            x = rnd(n, h, w, c)
            kern = lambda: wino_input_transform_nhwc_f32(x, m, pad)
            plain = lambda: wino_input_transform_nhwc_ref(x, m, pad)
            (top, bottom), (left, right) = pad
            tiles, (nh, nw) = tile_input(torch.nn.functional.pad(
                x, (0, 0, left, right, top, bottom)), m)
            t, in_floats = n * nh * nw, n * h * w * c
        # the yardstick, one fp32 call: V (PT^2, T, C) from tiles already
        # gathered (the gather not counted)
        kron = torch.kron(bt, bt)
        tiles_flat = tiles.reshape(t, pt * pt, c)
        lib = lambda: torch.einsum("ij,tjc->itc", kron, tiles_flat)
        ops = 4.0 * pt ** 3 * t * c          # B^T d and (B^T d) B, dense
        nbytes = 4.0 * (in_floats + pt * pt * t * c)
        channels = c
    else:
        k, m = shape["k"], shape["m"]
        pt = m + 2
        at = torch.from_numpy(transform_matrices(m)[2]).cuda()
        if shape.get("layout") == "tiles":
            t = shape["t"]
            mm, b = rnd(pt * pt, t, k), rnd(k)
            kern = lambda: wino_output_transform_f32(mm, b, m, True)
            plain = lambda: wino_output_transform_ref(mm, b, m, True)
            out_floats = t * m * m * k
        else:
            # M and bias read once, the cropped Y written once
            out = (shape["n"], shape["ho"], shape["wo"])
            t = out[0] * common.cdiv(out[1], m) * common.cdiv(out[2], m)
            mm, b = rnd(pt * pt, t, k), rnd(k)
            kern = lambda: wino_output_transform_nhwc_f32(mm, b, m, out, True)
            plain = lambda: wino_output_transform_nhwc_ref(mm, b, m, out,
                                                           True)
            out_floats = out[0] * out[1] * out[2] * k
        # the yardstick, one fp32 call: (T, m^2, K), no bias, no ReLU
        kron = torch.kron(at, at)
        lib = lambda: torch.einsum("ij,jtk->tik", kron, mm)
        ops = 2.0 * (m * pt * pt + m * m * pt) * t * k
        nbytes = 4.0 * (pt * pt * t * k + k + out_floats)
        channels = k
    y, y_ref = kern(), plain()
    torch.cuda.synchronize()
    if name.startswith("wino_"):
        # float4 accesses wherever the channels come in fours (these
        # operands are 16-byte aligned), the scalar body else
        route = common.last_route(name)
        if route != ("vec4" if channels % 4 == 0 else "scalar"):
            raise AssertionError(f"{name} {shape}: route {route}")
        extra["route"] = route
    if gemm is not None:
        # the tensor cores take every call with M >= 64 and K, N multiples
        # of 4 (K1/K2) or of 16 (K5) (these operands are 16-byte aligned);
        # the FMA or dp4a body the rest
        m_, k_, n_ = gemm
        mult_of, tc_route = (16, "tc_s8") if exact else (4, "tc3xtf32")
        expected_tc = m_ >= 64 and k_ % mult_of == 0 and n_ % mult_of == 0
        route = common.last_route(name)
        if (route == tc_route) != expected_tc:
            raise AssertionError(f"{name} {shape}: route {route}")
        extra["route"] = route
    if exact:
        err = float((y.int() - y_ref.int()).abs().max())
        tol = 0.0
    elif elementwise:
        diff = (y.float() - y_ref.float()).abs()
        lim = BF16_STEP * y_ref.float().abs() + BF16_ABS
        # the worst element's share of its own limit; must not exceed 1
        ratio = float((diff / lim).max())
        err, tol = float(diff.max()), None
        extra["worst_elem_ratio"] = ratio
        if not ratio <= 1.0:
            raise AssertionError(
                f"{name} {shape}: an element differs by {ratio:.3f} x "
                f"(2**-7 |ref| + {BF16_ABS:g}); max|diff| {err:.3e}")
        del diff, lim
    else:
        err = float((y.float() - y_ref.float()).abs().max())
        tol = rel * max(1.0, float(y_ref.float().abs().max()))
    if tol is not None and not err <= tol:
        raise AssertionError(f"{name} {shape}: max|diff| {err:.3e} > {tol:.3e}")
    del y, y_ref
    if gemm is not None and not exact:
        # an fp32-accurate product on the tensor cores takes three TF32
        # products (3xTF32); the bound on the fp32 FMA pipes beside it
        bound_ms, bound_by = bound(3.0 * ops, nbytes, PEAK_TF32_FLOPS)
        extra["fma_bound_ms"] = bound(ops, nbytes, PEAK_FP32_FLOPS)[0]
    else:
        bound_ms, bound_by = bound(ops, nbytes, peak)
    ms = time_ms(kern)
    # useful work per second, and the share of the bound the kernel reaches
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=time_ms(plain),
                library_ms=None if lib is None else time_ms(lib),
                bound_ms=bound_ms, bound_by=bound_by,
                useful_tflops=ops / ms * 1e-9, bound_share=bound_ms / ms,
                **extra)


def dw_chain_specs() -> list:
    """The reference's depthwise chain (conv -> depthwise -> depthwise,
    stride 2 -> FC, ``tests/test_residual_ops.py``) at a card's width, with
    a pool so the FC input fits the ISA's 16-bit FC dims."""
    from repro_torch.core.hybrid_conv import (
        ConvSpec,
        DepthwiseSpec,
        FCSpec,
        PoolSpec,
    )
    return [ConvSpec("c1", 56, 56, 64, 128, relu=True),
            DepthwiseSpec("d1", 56, 56, 128, relu=True),
            DepthwiseSpec("d2", 56, 56, 128, stride=2),
            PoolSpec("p1", 28, 28, 128),
            FCSpec("f1", 14 * 14 * 128, N_CLASSES)]


def path_specs(path: str):
    """A CNN path's layer specs and its input's (H, W, C)."""
    from repro_torch.models import resnet, vgg
    if path in DW_PATHS:
        return dw_chain_specs(), (56, 56, 64)
    if path.startswith("vgg16"):
        return vgg.network_specs(224, 1, n_classes=N_CLASSES), (224, 224, 3)
    return resnet.resnet18_specs(128, 1, n_classes=N_CLASSES), (128, 128, 3)


def serve_path(path: str, x: torch.Tensor, params=None) -> dict:
    """Build ``path``'s accelerator on the hopper PE, answer one first and
    ``STEADY_REQUESTS`` steady requests with the launch counts reset just
    before, check them per request, and hold the logits against the torch
    backend. Returns the accelerator, its outputs and timings."""
    from repro_torch import api
    from repro_torch.core import perf_model as pm
    from repro_torch.core.runtime import HybridRuntime
    from repro_torch.kernels import common

    specs, _ = path_specs(path)
    dtype = "int8" if path.endswith("int8") else "float32"
    t0 = time.perf_counter()
    acc = api.Accelerator.build(specs, pm.V5E, batch=BATCH, backend="hopper",
                                dtype=dtype, params=params, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_requests = 1 + STEADY_REQUESTS

    common.reset_launches()
    t0 = time.perf_counter()
    y = acc(x)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    first_counts = {k: v for k, v in common.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    for _ in range(STEADY_REQUESTS):
        y = acc(x)
    torch.cuda.synchronize()
    t_steady = (time.perf_counter() - t0) / STEADY_REQUESTS
    launches = dict(common.LAUNCHES)

    expected = PATHS[path]
    if first_counts != expected:
        raise AssertionError(f"{path}: launches per request {first_counts} "
                             f"!= {expected}")
    for name in common.KERNELS:
        if launches[name] != expected.get(name, 0) * n_requests:
            raise AssertionError(f"{path}: {name} launched {launches[name]} "
                                 f"times over {n_requests} requests")
    y_np = y.cpu().numpy()
    if y_np.shape != (BATCH, N_CLASSES) or not np.isfinite(y_np).all():
        raise AssertionError(f"{path}: logits shape {y_np.shape} or "
                             f"non-finite values")

    # the torch backend on the same card, same params (and sidecar)
    if dtype == "int8":
        rt = HybridRuntime(acc.program, backend="torch", device="cuda",
                           quant=acc.quant)
        rt.load_params(acc.params)
        q = acc.quant.quantize_input(x)
        y_i8 = acc.runtime.run(q)
        y_ref_i8 = rt.run(q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEADY_REQUESTS):
            y_ref_i8 = rt.run(q)
        torch.cuda.synchronize()
        t_ref = (time.perf_counter() - t0) / STEADY_REQUESTS
        if not torch.equal(y_i8, y_ref_i8):
            n_bad = int((y_i8 != y_ref_i8).sum())
            raise AssertionError(f"{path}: int8 logits differ from "
                                 f"backend='torch' in {n_bad} places")
        err, tol = 0.0, 0.0
    else:
        ref = api.Accelerator.build(specs, pm.V5E, batch=BATCH,
                                    backend="torch", params=acc.params,
                                    device="cuda")
        y_ref = ref(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEADY_REQUESTS):
            y_ref = ref(x)
        torch.cuda.synchronize()
        t_ref = (time.perf_counter() - t0) / STEADY_REQUESTS
        ref_np = y_ref.cpu().numpy()
        err = float(np.abs(y_np - ref_np).max())
        tol = 1e-3 * float(np.abs(ref_np).max())
        if not err <= tol:
            raise AssertionError(f"{path}: hopper vs torch logits max|diff| "
                                 f"{err:.3e} > {tol:.3e}")
        del ref
    if any(cl.kind == "dw" for cl in acc.program.layers):
        # both backends run the same depthwise op, so the card's is held to
        # the CPU's, which the CPU tests pin to the reference
        cpu = HybridRuntime(acc.program, backend="torch", device="cpu",
                            quant=acc.quant)
        cpu.load_params([(w.cpu(), b.cpu()) for w, b in acc.params])
        inp = acc.quant.quantize_input(x) if dtype == "int8" else x
        y_card, y_cpu = acc.runtime.run(inp).cpu(), cpu.run(inp.cpu())
        err_cpu = float((y_card.float() - y_cpu.float()).abs().max())
        tol_cpu = 0.0 if dtype == "int8" else 1e-3 * float(
            y_cpu.abs().max())
        if not err_cpu <= tol_cpu:
            raise AssertionError(f"{path}: card vs CPU logits max|diff| "
                                 f"{err_cpu:.3e} > {tol_cpu:.3e}")
        print(f"path {path}: vs the same program on the CPU max|diff| "
              f"{err_cpu:.3e} (tolerance {tol_cpu:.3e})", flush=True)
    modes = sorted({cl.plan.mode for cl in acc.program.layers
                    if cl.kind == "conv"})
    calib = (f" (calibration {acc.calib_ms:.0f}ms)"
             if acc.calib_ms is not None else "")
    print(f"path {path}: batch {BATCH}, {acc.n_instructions} instructions, "
          f"CONV modes {modes}; build {t_build * 1e3:.0f}ms{calib}; first "
          f"request {t_first * 1e3:.1f}ms; steady {t_steady * 1e3:.2f}"
          f"ms/batch ({BATCH / t_steady:.1f} images/s) over "
          f"{STEADY_REQUESTS} requests; launches per request {first_counts};"
          f" vs backend='torch' ({t_ref * 1e3:.2f}ms/batch): max|diff| "
          f"{err:.3e} (tolerance {tol:.3e})", flush=True)
    print(json.dumps({"path": path, "build_ms": t_build * 1e3,
                      "calib_ms": acc.calib_ms, "first_ms": t_first * 1e3,
                      "steady_ms": t_steady * 1e3,
                      "torch_backend_ms": t_ref * 1e3,
                      "launches_per_request": first_counts,
                      "max_abs_diff_vs_torch": err, "tol": tol}), flush=True)
    return dict(acc=acc, y=y, launches=launches, steady_ms=t_steady * 1e3)


def session_launches_per_batch(acc, x: torch.Tensor, buckets) -> dict:
    """Each bucket's launches per batch, from ``acc(x[:b])`` (the same
    cached executor entry the session runs for bucket ``b``): the expected
    growth of the counts for one session batch in that bucket."""
    from repro_torch.kernels import common
    out = {}
    for b in buckets:
        common.reset_launches()
        acc(x[:b])
        torch.cuda.synchronize()
        out[b] = {k: v for k, v in common.LAUNCHES.items() if v}
    return out


def check_session_launches(label: str, counts: dict, batches: int,
                           per_bucket: dict, per_request: dict) -> None:
    """The counts a session run left must be phase 3's per-request launches
    times the session's batches: every bucket launches the batch-8
    request's kernels (one dispatch per layer)."""
    odd = {b: c for b, c in per_bucket.items() if c != per_request}
    if odd:
        raise AssertionError(f"{label}: buckets launching unlike the batch-8 "
                             f"request {per_request}: {odd}")
    expected = {k: v * batches for k, v in per_request.items()}
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts} over {batches} "
                             f"session batches, expected {expected}")


def serve_session_path(path: str, served: dict, x: torch.Tensor,
                       card: str) -> dict:
    """Phase 3b on one CNN model path, over phase 3's accelerator, each
    traffic pattern in a session of its own of ``acc.serve(max_batch=8,
    warmup=True)``: (1) bulk: ``run_many`` of 16 requests of 8 images,
    each result bit for bit ``acc(x)`` on the same batch (same bucket,
    offset 0, the same entry); (2) two arrival windows (``arrival_window``)
    at 80 % of the direct path's images/s and at 80 % of what the session
    sustained (the lower of the bulk rate and the first window's served
    rate). Every run
    has the launch counts set to 0 just before and read just after, and
    each session must end clean (``check_session_ledger``). Also times the
    host staging of one batch (``_stage``: the request checks and, for
    int8, the quantization), the host work the session adds per batch."""
    from repro_torch.kernels import common

    acc, per_request = served["acc"], PATHS[path]
    rng = np.random.default_rng(11)
    batches = [torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
        np.float32)) for _ in range(SESSION_BULK)]
    direct = [acc(b.cuda()).cpu().numpy() for b in batches]
    host = [b.numpy() for b in batches]
    torch.cuda.synchronize()
    direct_ips = BATCH / (served["steady_ms"] / 1e3)

    # (1) bulk
    t0 = time.perf_counter()
    session = acc.serve(max_batch=BATCH, warmup=True)
    warm_s = time.perf_counter() - t0
    try:
        per_bucket = session_launches_per_batch(acc, x, session.buckets)
        stage_ms = []
        for b in host[:5]:
            t0 = time.perf_counter()
            session._stage(b)
            stage_ms.append((time.perf_counter() - t0) * 1e3)
        common.reset_launches()
        t0 = time.perf_counter()
        outs = session.run_many(host)
        bulk_s = time.perf_counter() - t0
        bulk_launches = {k: v for k, v in common.LAUNCHES.items() if v}
    finally:
        session.close()
    bulk_st = session.stats
    check_session_ledger(f"{path} session bulk", bulk_st)
    check_session_launches(f"{path} session bulk", bulk_launches,
                           bulk_st.batches, {BATCH: per_bucket[BATCH]},
                           per_request)
    for i, (got, ref) in enumerate(zip(outs, direct)):
        if not np.array_equal(got, ref):
            raise AssertionError(
                f"{path} session bulk: request {i} differs from acc(x) in "
                f"{int((got != ref).sum())} places, max|diff| "
                f"{float(np.abs(got - ref).max()):.3e}")
    n_images = SESSION_BULK * BATCH
    bulk_ips = n_images / bulk_s
    bulk_ms = bulk_s * 1e3 / bulk_st.batches
    print(f"path {path} session ({card}): warmup of buckets "
          f"{session.buckets} {warm_s * 1e3:.0f}ms (compile_ms "
          f"{bulk_st.compile_ms:.0f}); bulk run_many of {SESSION_BULK} x "
          f"{BATCH} images {bulk_s * 1e3:.1f}ms = {bulk_ms:.2f}ms/batch "
          f"({bulk_ips:.1f} images/s) against the direct path's "
          f"{served['steady_ms']:.2f}ms/batch ({direct_ips:.1f} images/s), "
          f"{bulk_st.batches} batches, bit-equal to acc(x); host staging "
          f"{fmt_ms(stage_ms)}ms a batch; launches {bulk_launches}",
          flush=True)

    # (2) open-loop arrivals of single images, drawn from the bulk images
    images, refs = np.concatenate(host), np.concatenate(direct)
    windows = []
    launches = dict.fromkeys(common.KERNELS, 0)
    for k, v in bulk_launches.items():
        launches[k] += v
    for basis in ("direct", "sustained"):
        ips = (direct_ips if basis == "direct" else
               min(bulk_ips, windows[0]["served_images_per_s"]))
        w = arrival_window(f"{path} session arrivals", acc, images, refs,
                           SESSION_LOAD * ips, rng, per_bucket, per_request)
        w["basis"] = f"{SESSION_LOAD:.0%} of {basis}"
        windows.append(w)
        for k, v in w.pop("launches").items():
            launches[k] += v
        lat = ("overloaded: the queue grew, no percentile" if w["overloaded"]
               else f"latency p50 {w['latency_p50_ms']:.2f}ms p95 "
                    f"{w['latency_p95_ms']:.2f}ms, queue wait p50 "
                    f"{w['wait_p50_ms']:.2f}ms p95 {w['wait_p95_ms']:.2f}ms")
        print(f"path {path} session arrivals ({card}): {SESSION_ARRIVALS} "
              f"single images offered at {w['offered_images_per_s']:.1f} "
              f"images/s ({w['basis']}, target {w['rate']:.1f}), served "
              f"{w['served_images_per_s']:.1f} images/s over "
              f"{w['window_s'] * 1e3:.0f}ms: {lat}; {w['batches']} batches, "
              f"{w['padded_rows']} padded rows, occupancy "
              f"{w['occupancy']:.3f}; vs acc(x) rows max|diff| "
              f"{w['max_abs_diff']:.3e} (tolerance {w['tol']:.3e}); ledger "
              f"clean", flush=True)
    print(json.dumps({"path": path, "phase": "session", "card": card,
                      "bulk_ms_per_batch": bulk_ms,
                      "bulk_images_per_s": bulk_ips,
                      "direct_ms_per_batch": served["steady_ms"],
                      "host_staging_ms_per_batch": stage_ms,
                      "compile_ms": bulk_st.compile_ms,
                      "arrivals": windows,
                      "per_bucket_launches": {str(b): c for b, c
                                              in per_bucket.items()}}),
          flush=True)
    return dict(launches=launches)


def arrival_window(label: str, acc, images: np.ndarray, refs: np.ndarray,
                   rate: float, rng, per_bucket: dict,
                   per_request: dict) -> dict:
    """``SESSION_ARRIVALS`` single images, drawn from ``images`` (seeded),
    submitted by this thread at open-loop Poisson ``rate`` into a session
    of its own; each result held to its row of ``refs`` (int8 bit for bit,
    fp32 within ``1e-3 * max|logit|``: another bucket may take another
    route). The served rate is the images over the time from the first
    submit to the last result; below ``OVERLOAD`` of the offered rate the
    window is overloaded, and its percentiles would only measure the
    window's length, so none is reported."""
    from repro_torch.kernels import common
    pick = rng.integers(len(images), size=SESSION_ARRIVALS)
    at = np.cumsum(rng.exponential(1.0 / rate, SESSION_ARRIVALS))
    session = acc.serve(max_batch=BATCH, warmup=True)
    try:
        common.reset_launches()
        futs = []
        t0 = time.perf_counter()
        for i, t_at in zip(pick, at):
            delay = t0 + t_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            futs.append(session.submit(images[i]))
        submit_s = time.perf_counter() - t0
        rows = np.stack([f.result(timeout=300) for f in futs])
        window_s = time.perf_counter() - t0
        counts = {k: v for k, v in common.LAUNCHES.items() if v}
    finally:
        session.close()
    st = session.stats
    check_session_ledger(label, st)
    check_session_launches(label, counts, st.batches, per_bucket,
                           per_request)
    want = refs[pick]
    if acc.quant is not None:
        if not np.array_equal(rows, want):
            raise AssertionError(f"{label}: int8 logits differ from acc(x)'s "
                                 f"rows in {int((rows != want).sum())} places")
        err, tol = 0.0, 0.0
    else:
        err = float(np.abs(rows - want).max())
        tol = 1e-3 * float(np.abs(want).max())
        if not err <= tol:
            raise AssertionError(f"{label}: max|diff| {err:.3e} > {tol:.3e}")
    offered = SESSION_ARRIVALS / submit_s
    served = SESSION_ARRIVALS / window_s
    overloaded = served < OVERLOAD * offered
    return {"rate": rate, "offered_images_per_s": offered,
            "served_images_per_s": served, "window_s": window_s,
            "overloaded": overloaded,
            "latency_p50_ms": None if overloaded else st.p50_ms(),
            "latency_p95_ms": None if overloaded else st.p95_ms(),
            "wait_p50_ms": None if overloaded else st.wait_p50_ms(),
            "wait_p95_ms": None if overloaded else st.wait_p95_ms(),
            "batches": st.batches, "padded_rows": st.padded_rows,
            "occupancy": st.occupancy(), "max_abs_diff": err, "tol": tol,
            "launches": counts}


def check_session_ledger(label: str, st) -> None:
    """A clean session: every request answered, none degraded, isolated
    or retried, no restart, and ``submitted == requests + errors +
    shed``."""
    if (st.submitted != st.requests + st.errors + st.shed or st.errors
            or st.degraded or st.isolated or st.retries
            or st.watchdog_restarts):
        raise AssertionError(f"{label}: unclean ledger {st}")


def session_faults(served: dict, x: torch.Tensor, card: str) -> None:
    """Phase 3b faults on ResNet-18 fp32, one ``FaultPlan`` each, every
    result held bit for bit: (1) a one-shot ``execute`` error on the fourth
    of eight hopper batches of a ``run_many`` stream of 64 single images is
    bisected on hopper (2 retries, none isolated, nothing degraded), and
    every row equals ``acc(x)``'s; (2) one request-bound ("cursed") fault
    is isolated (``isolated == 1``; the innocent co-batched results equal
    a fault-free run); (3) three threads call ``run_many`` at once, eight
    requests of 8 images each, and every result equals ``acc(x)`` on its
    batch (the staging entries are bound to the pipeline slots)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serving import FaultPlan, FaultSpec, InjectedFault

    acc = served["acc"]
    rng = np.random.default_rng(13)
    batches = [rng.standard_normal(tuple(x.shape)).astype(np.float32)
               for _ in range(8)]
    direct = [acc(torch.from_numpy(b).cuda()).cpu().numpy() for b in batches]
    kw = dict(max_batch=BATCH, buckets=(BATCH,), max_wait_ms=50.0,
              warmup=True)

    plan = FaultPlan([FaultSpec(site="execute", kind="error", at=(3,),
                                match=(("backend", "hopper"),))])
    with acc.serve(fault_plan=plan, **kw) as s:
        rows = np.stack(s.run_many(list(np.concatenate(batches))))
        st = s.stats
    ref = np.concatenate(direct)
    if not (len(plan.fired()) == 1 and st.retries == 2 and st.isolated == 0
            and st.degraded == 0 and st.errors == 0 and st.requests == 64
            and np.array_equal(rows, ref)):
        raise AssertionError(f"session mid-stream failure: {st}; rows differ "
                             f"from acc(x) in {int((rows != ref).sum())} "
                             f"places")
    print(f"session faults ({card}): one execute error on hopper batch 4 of "
          f"8 in a run_many stream -> bisected on hopper ({st.retries} "
          f"retries, isolated {st.isolated}, degraded {st.degraded}); all 64 "
          f"rows bit-equal to acc(x)", flush=True)

    imgs = list(x.cpu().numpy())
    with acc.serve(**kw) as s:
        clean = [f.result(timeout=120) for f in s.submit_many(imgs)]
    cursed = 3
    plan = FaultPlan([FaultSpec(site="execute", kind="error",
                                requests=(cursed,), message="cursed")])
    with acc.serve(fault_plan=plan, **kw) as s:
        futs = s.submit_many(imgs)
        for i, f in enumerate(futs):
            if i == cursed:
                try:
                    f.result(timeout=120)
                except InjectedFault:
                    continue
                raise AssertionError("the cursed request was not isolated")
            if not np.array_equal(f.result(timeout=120), clean[i]):
                raise AssertionError(f"session isolation: innocent request "
                                     f"{i} differs from the fault-free run")
        st = s.stats
    if not (st.isolated == 1 and st.degraded == 0 and st.errors == 1
            and st.submitted == st.requests + st.errors + st.shed):
        raise AssertionError(f"session isolation: {st}")
    print(f"session faults ({card}): one cursed request -> isolated "
          f"{st.isolated} after {st.retries} bisection retries, degraded "
          f"{st.degraded}; {BATCH - 1} innocent co-batched results bit-equal "
          f"to the fault-free run", flush=True)

    orders = [rng.permutation(len(batches)) for _ in range(3)]
    with acc.serve(**kw) as s:
        with ThreadPoolExecutor(len(orders)) as pool:
            futs = [pool.submit(s.run_many, [batches[i] for i in order])
                    for order in orders]
            outs = [f.result(timeout=300) for f in futs]
        st = s.stats
    for order, out in zip(orders, outs):
        for i, got in zip(order, out):
            if not np.array_equal(got, direct[i]):
                raise AssertionError(
                    f"concurrent run_many: a result differs from acc(x) on "
                    f"its batch in {int((got != direct[i]).sum())} places")
    check_session_ledger("concurrent run_many", st)
    print(f"session concurrency ({card}): {len(orders)} threads calling "
          f"run_many at once, {st.batches} batches of {BATCH}, every result "
          f"bit-equal to acc(x) on its batch", flush=True)


def session_persistence(results: dict, xs: dict, card: str) -> None:
    """Phase 3b persistence: ``save_program`` / ``from_program(backend=
    "hopper")`` of VGG16 int8 and ResNet-18 fp32 built on the card; the
    reloaded accelerator's logits equal the original's bit for bit. Then
    ``summary()`` of VGG16."""
    from repro_torch import api
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in ("vgg16_int8", "resnet18_fp32"):
        acc = results[path]["acc"]
        x = xs[path_specs(path)[1]]
        saved = acc.save_program(str(out_dir / f"{path}.json"))
        again = api.Accelerator.from_program(saved, params=acc.params,
                                             backend="hopper",
                                             device="cuda")
        y, y2 = acc(x), again(x)
        if not torch.equal(y, y2):
            raise AssertionError(f"{path}: reloaded program differs in "
                                 f"{int((y != y2).sum())} places")
        print(f"path {path} persistence ({card}): save_program -> "
              f"from_program(backend='hopper'): {again.n_instructions} "
              f"instructions, logits bit-equal to the original "
              f"({Path(saved).stat().st_size} bytes)", flush=True)
    print(results["vgg16_fp32"]["acc"].summary(), flush=True)


def session_segmented(served: dict, x: torch.Tensor, card: str) -> dict:
    """Phase 3b segmented: VGG16 fp32 with ``segmented=True`` on hopper,
    the served params: 5 segment Programs, a host maxpool between them,
    the FC tail on K2: the same kernel calls on the same shapes, so its
    logits must equal the single Program's bit for bit and its launches
    per request the single Program's. Prints its ms/batch."""
    from repro_torch import api
    from repro_torch.kernels import common
    acc = served["acc"]
    seg = api.Accelerator.build(acc.specs, plans=acc.plans,
                                params=acc.params, batch=BATCH,
                                backend="hopper", segmented=True,
                                device="cuda")
    seg(x)
    torch.cuda.synchronize()
    y, times, per_request = timed_requests(seg, x)
    if per_request != PATHS["vgg16_fp32"]:
        raise AssertionError(f"segmented VGG16: launches per request "
                             f"{per_request} != {PATHS['vgg16_fp32']}")
    y_single = acc(x)
    err = float((y - y_single).abs().max())
    if not torch.equal(y, y_single):
        raise AssertionError(f"segmented VGG16 differs from the single "
                             f"Program: max|diff| {err:.3e}")
    print(f"path vgg16_fp32 segmented ({card}): "
          f"{len(seg.segment_runtimes)} segment Programs "
          f"({seg.n_instructions} instructions) + host maxpool + FC tail on "
          f"K2: {fmt_ms(times)}ms/batch over {STEADY_REQUESTS} requests "
          f"against the single Program's {served['steady_ms']:.2f}; vs the "
          f"single-Program logits max|diff| {err:.3e}; launches per request "
          f"{per_request}", flush=True)
    print(json.dumps({"path": "vgg16_fp32_segmented", "card": card,
                      "ms": times, "single_program_ms": served["steady_ms"],
                      "max_abs_diff_vs_single_program": err,
                      "launches_per_request": per_request}), flush=True)
    return dict(launches={k: v * STEADY_REQUESTS
                          for k, v in per_request.items()})


def path_program(path: str):
    """The program a phase-2 path runs, its dtype and whether it makes one
    PE call per COMP block (the interpreter's paths)."""
    from repro_torch.core import perf_model as pm
    from repro_torch.core.compiler import compile_network
    base = STRICT_PATHS.get(path, path)
    specs = path_specs(base)[0]
    dtype = "int8" if base.endswith("int8") else "float32"
    program = compile_network(
        specs, pm.V5E.run_dse(specs, batch=BATCH, dtype=dtype).plans)
    return program, dtype, path in STRICT_PATHS


def timed_requests(run, inp: torch.Tensor) -> tuple:
    """``STEADY_REQUESTS`` requests of ``run``, each timed on the host
    clock to a synchronise, with the launch counts set to 0 just before
    the first and read just after the last: (last output, ms per request,
    launches per request, or None where a count is not a multiple)."""
    from repro_torch.kernels import common
    common.reset_launches()
    times = []
    for _ in range(STEADY_REQUESTS):
        t0 = time.perf_counter()
        y = run(inp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_request = {k: (v // STEADY_REQUESTS if v % STEADY_REQUESTS == 0
                       else None)
                   for k, v in common.LAUNCHES.items() if v}
    return y, times, per_request


def fmt_ms(times: list) -> str:
    """Median [min-max] of per-request times."""
    return (f"{statistics.median(times):.2f} [{min(times):.2f}-"
            f"{max(times):.2f}]")


def kernel_delta(a: dict, b: dict, n: int = 5) -> list:
    """The ``n`` kernel names whose device time differs most between two
    profiles (:func:`device_profile` ``by_kernel``): ``[name, ms of a minus
    ms of b, calls of a minus calls of b]``."""
    rows = []
    for k in {*a, *b}:
        (ms_a, n_a), (ms_b, n_b) = a.get(k, (0.0, 0)), b.get(k, (0.0, 0))
        rows.append([k, ms_a - ms_b, n_a - n_b])
    return sorted(rows, key=lambda r: -abs(r[1]))[:n]


def hold_strict(label: str, acc, inp: torch.Tensor) -> dict:
    """``acc``'s program, params and sidecar on the strict interpreter with
    ``backend="hopper"``: one warm request, then ``STEADY_REQUESTS`` timed
    ones with the launch counts set to 0 just before and read just after
    (per request they must equal one PE call per COMP block and per FC),
    held bit for bit to an ``opt_level=0`` hopper executor on the same DRAM
    image (the same calls, timed the same way), and to the served
    ``opt_level=1`` executor: int8 bit for bit, fp32 within
    ``1e-3 * max|logit|``. One request of each under ``torch.profiler``
    says where the interpreter's extra time goes."""
    from repro_torch.core.runtime import HybridRuntime

    int8 = acc.quant is not None
    st = HybridRuntime(acc.program, strict=True, backend="hopper",
                       device="cuda", quant=acc.quant)
    st.load_params(acc.params)
    ex0 = HybridRuntime(acc.program, backend="hopper", opt_level=0,
                        device="cuda", quant=acc.quant)
    ex0.load_params(acc.params)
    st.run(inp)
    ex0.run(inp)
    torch.cuda.synchronize()
    y, interp_ms, launches = timed_requests(st.run, inp)
    expected = case_launches(kernel_cases(
        acc.program, BATCH, "int8" if int8 else "float32", per_block=True))
    if launches != expected:
        raise AssertionError(f"{label}: interpreter launches per request "
                             f"{launches} != one per COMP block and FC "
                             f"{expected}")
    y0, opt0_ms, launches0 = timed_requests(ex0.run, inp)
    if launches0 != launches:
        raise AssertionError(f"{label}: opt_level=0 executor launches "
                             f"{launches0} != interpreter's {launches}")
    if not torch.equal(y, y0):
        raise AssertionError(
            f"{label}: interpreter differs from the opt_level=0 executor in "
            f"{int((y != y0).sum())} places, max|diff| "
            f"{float((y.float() - y0.float()).abs().max()):.3e}")
    y1 = acc.runtime.run(inp)
    torch.cuda.synchronize()
    if int8:
        if not torch.equal(y, y1):
            raise AssertionError(f"{label}: int8 interpreter differs from the "
                                 f"served executor in "
                                 f"{int((y != y1).sum())} places")
        err, tol = 0.0, 0.0
    else:
        err = float((y - y1).abs().max())
        tol = 1e-3 * float(y1.abs().max())
        if not err <= tol:
            raise AssertionError(f"{label}: interpreter vs served executor "
                                 f"max|diff| {err:.3e} > {tol:.3e}")
    if not torch.isfinite(y.float()).all():
        raise AssertionError(f"{label}: non-finite interpreter output")
    prof = {"interp": device_profile(lambda: st.run(inp), by_kernel=True),
            "opt0": device_profile(lambda: ex0.run(inp), by_kernel=True)}
    delta = kernel_delta(prof["interp"].pop("by_kernel"),
                         prof["opt0"].pop("by_kernel"))
    return dict(y=y, launches=launches, interp_ms=interp_ms,
                opt0_ms=opt0_ms, max_abs_diff_vs_served=err, tol=tol,
                equal_to_served=err == 0, profile=prof,
                device_delta=delta)


def interpret_path(path: str, served: dict, x: torch.Tensor,
                   card: str) -> dict:
    """Phase 4 (a): the strict interpreter on ``path``'s served program,
    params and sidecar (:func:`hold_strict`). Every kernel the served
    executor launches must launch on the interpreted request too."""
    acc = served["acc"]
    inp = acc.quant.quantize_input(x) if acc.quant is not None else x
    r = hold_strict(f"{path}_strict", acc, inp)
    missing = [k for k in PATHS[path] if not r["launches"].get(k)]
    if missing:
        raise AssertionError(f"{path}_strict: {missing} never launched")
    pi, p0 = r["profile"]["interp"], r["profile"]["opt0"]
    print(f"path {path}_strict ({card}): batch {BATCH}, interpreted "
          f"requests {fmt_ms(r['interp_ms'])}ms against the served "
          f"executor's steady {served['steady_ms']:.2f}ms/batch and the "
          f"opt_level=0 executor's {fmt_ms(r['opt0_ms'])}ms over "
          f"{STEADY_REQUESTS} requests; launches per interpreted request "
          f"{r['launches']} (served executor {PATHS[path]}); bit-equal to "
          f"opt_level=0; vs the served executor max|diff| "
          f"{r['max_abs_diff_vs_served']:.3e} (equal: "
          f"{r['equal_to_served']}, tolerance {r['tol']:.3e})", flush=True)
    print(f"path {path}_strict profile, one request: interpreter wall "
          f"{pi['wall_ms']:.2f}ms, device busy {pi['device_busy_ms']:.3f}ms "
          f"over {pi['n_kernels']} kernels; opt_level=0 wall "
          f"{p0['wall_ms']:.2f}ms, device busy {p0['device_busy_ms']:.3f}ms "
          f"over {p0['n_kernels']} kernels; largest device differences: "
          + "; ".join(f"{k[:60]} {ms:+.3f}ms {n:+d} calls"
                      for k, ms, n in r["device_delta"]), flush=True)
    print(json.dumps({"path": f"{path}_strict", "card": card,
                      "interp_ms": r["interp_ms"], "opt0_ms": r["opt0_ms"],
                      "served_steady_ms": served["steady_ms"],
                      "launches_per_request": r["launches"],
                      "served_launches_per_request": PATHS[path],
                      "max_abs_diff_vs_served": r["max_abs_diff_vs_served"],
                      "equal_to_served": r["equal_to_served"],
                      "tol": r["tol"], "profile": r["profile"],
                      "device_delta_vs_opt0": r["device_delta"]}),
          flush=True)
    return r


def device_profile(fn, by_kernel: bool = False) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its wall ms (ending in a
    synchronise, profiler overhead included), the summed device time of
    the kernels it ran, and its five longest kernels by name (with
    ``by_kernel``, every kernel name's device ms and calls too). A busy
    time of 0 means the profiler saw no device activity: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               n_kernels=sum(e.count for e in kernels),
               top=[[e.key[:80], e.self_device_time_total / 1e3, e.count]
                    for e in top])
    if by_kernel:
        out["by_kernel"] = {e.key: (e.self_device_time_total / 1e3, e.count)
                            for e in kernels}
    return out


def serve_lm(k6_ms: float) -> dict:
    """Serve full-width minitron-8b (bf16, random weights from seed 0)
    through ``launch.serve.serve`` on the hopper backend, with the launch
    counts set to 0 just before and checked just after; check them per
    phase on a second prefill and one decode step; hold the last-token
    prefill logits against ``backend="torch"`` on the same params.
    ``k6_ms`` is phase 2's K6 time per request (all layers)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.launch.serve import serve
    from repro_torch.train import steps

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(reduced=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
              gen=LM_GEN, seed=0, device="cuda", params=params)

    common.reset_launches()
    out = serve(LM_ARCH, backend="hopper", **kw)
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    expected = PATHS[LM_PATH]
    for name in common.KERNELS:
        if launches[name] != expected.get(name, 0):
            raise AssertionError(f"{LM_PATH}: {name} launched "
                                 f"{launches[name]} times in one request, "
                                 f"expected {expected.get(name, 0)}")
    y = out.prefill_logits.float()
    if y.shape != (LM_BATCH, cfg.vocab_size) or not torch.isfinite(y).all():
        raise AssertionError(f"{LM_PATH}: prefill logits {tuple(y.shape)} "
                             f"or non-finite values")

    # per phase, on the same prompts (serve draws them from seed 0)
    prefill, decode = steps.make_serve_steps(cfg, backend="hopper")
    cache = steps.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, "cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)).cuda()
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, cache)
    torch.cuda.synchronize()
    warm_prefill_ms = (time.perf_counter() - t0) * 1e3
    n_prefill = common.LAUNCHES["flash_attention"]
    common.reset_launches()
    decode(params, logits.argmax(-1)[:, None], cache, LM_PROMPT)
    torch.cuda.synchronize()
    n_decode = common.LAUNCHES["flash_attention"]
    if (n_prefill, n_decode) != (cfg.n_layers, 0):
        raise AssertionError(f"{LM_PATH}: K6 launched {n_prefill} times in "
                             f"a prefill and {n_decode} in a decode step, "
                             f"expected {cfg.n_layers} and 0")
    repeat_diff = float((logits.float() - y).abs().max())
    # where the device time goes, and how much of the wall time it fills
    prof_prefill = device_profile(lambda: prefill(params, prompts, cache))
    tok = logits.argmax(-1)[:, None]
    prof_decode = device_profile(
        lambda: decode(params, tok, cache, LM_PROMPT + 1))
    del cache, logits

    ref = serve(LM_ARCH, backend="torch", **kw)
    y_ref = ref.prefill_logits.float()
    err = float((y - y_ref).abs().max())
    tol = LM_TOL * float(y_ref.abs().max())
    if not err <= tol:
        raise AssertionError(f"{LM_PATH}: hopper vs torch prefill logits "
                             f"max|diff| {err:.3e} > {tol:.3e}")
    agree = float((out.tokens == ref.tokens).mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = LM_BATCH * LM_PROMPT
    print(f"path {LM_PATH}: batch {LM_BATCH}, prompt {LM_PROMPT}, "
          f"{LM_GEN} greedy tokens; build (random weights) {build_ms:.0f}ms;"
          f" prefill {out.prefill_ms:.1f}ms first, {warm_prefill_ms:.1f}ms "
          f"again ({n_tok / warm_prefill_ms * 1e3:.0f} tokens/s); K6 "
          f"{k6_ms:.1f}ms of it ({k6_ms / warm_prefill_ms:.1%}); decode "
          f"{out.decode_ms_per_token:.2f}ms/token "
          f"({LM_BATCH / out.decode_ms_per_token * 1e3:.1f} tokens/s); "
          f"launches {launches} (prefill {n_prefill}, decode step "
          f"{n_decode}); peak memory {peak_gb:.2f} GB; vs backend='torch' "
          f"(prefill {ref.prefill_ms:.1f}ms, decode "
          f"{ref.decode_ms_per_token:.2f}ms/token): max|diff| {err:.3e} "
          f"(tolerance {tol:.3e}, max|logit| {float(y_ref.abs().max()):.3e})"
          f", greedy tokens agree {agree:.3f}", flush=True)
    for phase, pr in (("prefill", prof_prefill), ("decode step", prof_decode)):
        print(f"path {LM_PATH} profile, one {phase}: wall "
              f"{pr['wall_ms']:.1f}ms under the profiler, device busy "
              f"{pr['device_busy_ms']:.2f}ms over {pr['n_kernels']} kernels;"
              f" longest: " + "; ".join(f"{k} {ms:.2f}ms x{n}"
                                        for k, ms, n in pr["top"]),
              flush=True)
    print(json.dumps({
        "path": LM_PATH, "build_ms": build_ms,
        "prefill_ms": out.prefill_ms, "warm_prefill_ms": warm_prefill_ms,
        "decode_ms_per_token": out.decode_ms_per_token,
        "k6_ms_per_prefill": k6_ms,
        "torch_backend_prefill_ms": ref.prefill_ms,
        "torch_backend_decode_ms_per_token": ref.decode_ms_per_token,
        "launches_per_request": launches, "launches_prefill": n_prefill,
        "launches_decode_step": n_decode, "peak_memory_gb": peak_gb,
        "max_abs_diff_vs_torch": err, "tol": tol,
        "repeat_prefill_max_abs_diff": repeat_diff,
        "greedy_token_agreement": agree,
        "profile_prefill": prof_prefill, "profile_decode_step": prof_decode}),
        flush=True)
    return dict(launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.compat import use_strict_fp32
    from repro_torch.kernels import common

    # -- phase 1: card, numerics, build ---------------------------------------
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    use_strict_fp32()
    t0 = time.perf_counter()
    lib_path = common.build_library()
    common.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s -> "
          f"{Path(lib_path).name}", flush=True)
    for line in ptxas_summary(common.BUILD_LOG):
        print(f"ptxas: {line}", flush=True)
    for line in ptxas_warnings(common.BUILD_LOG):
        print(f"nvcc: {line}", flush=True)

    # -- phase 2: every kernel at every main-path shape vs its plain version --
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                             bound_ms=0.0, library_ms=None, bound_by={})
                  for name in common.KERNELS}
    seen: dict[tuple, dict] = {}
    fields = ("ms", "plain_ms", "bound_ms", "library_ms")
    for path in [*PATHS, *STRICT_PATHS]:
        if path == LM_PATH:
            cases = lm_kernel_cases()
        else:
            program, dtype, per_block = path_program(path)
            cases = kernel_cases(program, BATCH, dtype, per_block)
            if path == "resnet18_fp32":
                cases += wino_offpath_cases()
        counted, per_path = case_launches(cases), {}
        if path in PATHS and counted != PATHS[path]:
            raise AssertionError(f"{path}: program gives launches {counted}, "
                                 f"expected {PATHS[path]}")
        for name, layer, shape, n in cases:
            key = (name, tuple(sorted(shape.items())))
            if key not in seen:
                seen[key] = run_case(name, shape, gen)
                torch.cuda.empty_cache()
            r = seen[key]
            print(json.dumps({"kernel": name, "path": path, "layer": layer,
                              **shape, **r}), flush=True)
            if name == "flash_attention":
                err = (f"worst element {r['worst_elem_ratio']:.3f} of one "
                       f"bf16 step" if "worst_elem_ratio" in r else
                       f"max|diff| {r['max_abs_err']:.2e}")
                print(f"K6 {layer}: {r['ms']:.3f}ms, "
                      f"{r['useful_tflops']:.1f} TFLOP/s useful, "
                      f"{r['bound_share']:.1%} of its bound "
                      f"({r['bound_ms']:.3f}ms); SDPA {r['library_ms']:.3f}"
                      f"ms, plain {r['plain_ms']:.3f}ms; {err}", flush=True)
            pk = per_path.setdefault(name, dict.fromkeys(fields, 0.0))
            for f in fields:
                pk[f] += n * (r[f] or 0.0)
            agg = per_kernel[name]
            agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
            if path not in PATHS or path in DW_PATHS:
                continue     # the summary's times: the served model paths
            for f in ("ms", "plain_ms", "bound_ms"):
                agg[f] += n * r[f]
            if r["library_ms"] is not None:
                agg["library_ms"] = ((agg["library_ms"] or 0.0)
                                     + n * r["library_ms"])
            agg["bound_by"][r["bound_by"]] = (
                agg["bound_by"].get(r["bound_by"], 0) + n * r["bound_ms"])
        # per-request sums of this path's kernel calls (library_ms 0: none)
        print(json.dumps({"path_kernels": path, **per_path}), flush=True)
    print(f"phase 2 (kernel checks): {time.perf_counter() - t_start:.1f}s "
          f"since start", flush=True)

    # -- phase 3: the main paths through the user's entry points -------------
    xs = {}           # one batch of images per input shape
    total = dict.fromkeys(common.KERNELS, 0)
    results = {}
    for path in PATHS:
        if path == LM_PATH:
            continue
        shape = path_specs(path)[1]
        if shape not in xs:
            xs[shape] = torch.from_numpy(np.random.default_rng(1)
                                         .standard_normal((BATCH, *shape))
                                         .astype(np.float32)).cuda()
        # the int8 builds quantize the fp32 build's weights
        fp32 = results.get(path.replace("int8", "fp32"))
        results[path] = serve_path(path, xs[shape],
                                   params=fp32["acc"].params if fp32 else None)
        for name, n in results[path]["launches"].items():
            total[name] += n
        if fp32 is not None:
            y8 = results[path]["y"].argmax(-1)
            agree = float((y8 == fp32["y"].argmax(-1)).float().mean())
            print(f"path {path}: top-1 agreement of the dequantized int8 "
                  f"logits with the fp32 hopper path: {agree:.3f} over "
                  f"{BATCH} images (random weights)", flush=True)
        torch.cuda.empty_cache()
    kernel_ms = sum(a["ms"] for name, a in per_kernel.items()
                    if name != "flash_attention")
    print(f"kernel time per request of each CNN model path, summed over the "
          f"paths "
          f"(phase 2): {kernel_ms:.2f}ms; steady ms/batch: "
          + ", ".join(f"{p} {r['steady_ms']:.2f}" for p, r in results.items()),
          flush=True)

    # -- phase 3b: the four model paths through a ServingSession ------------
    t_3b = time.perf_counter()
    for path in SESSION_PATHS:
        r = serve_session_path(path, results[path],
                               xs[path_specs(path)[1]], card)
        for name, n in r["launches"].items():
            total[name] += n
    session_faults(results["resnet18_fp32"],
                   xs[path_specs("resnet18_fp32")[1]], card)
    session_persistence(results, xs, card)
    r = session_segmented(results["vgg16_fp32"],
                          xs[path_specs("vgg16_fp32")[1]], card)
    for name, n in r["launches"].items():
        total[name] += n
    torch.cuda.empty_cache()
    print(f"phase 3b (sessions): {time.perf_counter() - t_3b:.1f}s; "
          f"{time.perf_counter() - t_start:.1f}s since start", flush=True)

    # -- phase 4: the strict interpreter on every CNN path --------------------
    for path, served in results.items():
        r = interpret_path(path, served, xs[path_specs(path)[1]], card)
        for name, n in r["launches"].items():
            total[name] += n * STEADY_REQUESTS
        served.pop("acc")
        del r
        torch.cuda.empty_cache()
    print(f"phase 4 (interpreter): {time.perf_counter() - t_start:.1f}s "
          f"since start", flush=True)
    del results, xs
    torch.cuda.empty_cache()

    # -- phase 5: the LM path through repro_torch.launch.serve ---------------
    lm = serve_lm(k6_ms=per_kernel["flash_attention"]["ms"])
    for name, n in lm["launches"].items():
        total[name] += n
    print(f"whole run: {time.perf_counter() - t_start:.1f}s", flush=True)

    summary = []
    for name in common.KERNELS:
        a = per_kernel[name]
        source, replaces = SOURCES[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": total[name],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": max(a["bound_by"], key=a["bound_by"].get,
                            default="bytes"),
            "library_ms": a["library_ms"]})
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
