"""Where the GEMM kernels' tensor-core time goes on the card: K1/K2's
3xTF32 body and K5's s8 body, each against variants of itself.

    PYTHONPATH=src python -m repro_torch.kernels.gemm.breakdown [--only k12|k5]

Each variant is ``csrc/gemm_f32.cu`` or ``csrc/gemm_i8.cu`` with a few
passages replaced: either one design choice undone (to show what it is
worth) or one part of the work dropped (to show what it costs). The
variants are built with ``nvcc`` in parallel into
``build/repro_torch/gemm_variants/``, then run in turns, the committed
kernel first and last, at main-path shapes (VGG16 and ResNet-18 at batch 8)
that take the tensor-core route. For each: the median CUDA-event time per
shape and, beside them, the library call on the same operands
(``torch.addmm`` / ``torch.bmm`` for K1/K2, ``torch._int_mm`` for K5, the
product alone) and the floors (K1/K2: fp32 FMA pipes and 3xTF32; K5: int8
tensor cores and HBM bytes). A variant that drops work computes something
else, so its largest difference from the plain version is printed, not
checked (K5's committed kernel must match bit for bit). A passage that is
no longer in the source raises: the variants follow the kernel. The ptxas
notes of each build (registers, spills, serialized ``wgmma``) are printed
too. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess

import torch

from repro_torch.kernels import common, variants

SOURCE = common.CSRC_DIR / "gemm_f32.cu"
I8_SOURCE = common.CSRC_DIR / "gemm_i8.cu"
OUT_DIR = common.BUILD_DIR / "gemm_variants"
PEAK_FP32, PEAK_TF32, PEAK_HBM = 67e12, 494.7e12, 3.35e12
PEAK_INT8 = 1979e12

# (label, G, M, K, N): K1 calls have G = 0 (conv_gemm_f32), K2 calls G >= 1
SHAPES = [
    ("vgg16 conv3 (K1)", 0, 100352, 1152, 128),
    ("vgg16 conv5 (K1)", 0, 25088, 2304, 256),
    ("vgg16 conv10 (K1, split K)", 0, 1568, 4608, 512),
    ("vgg16 conv1 (K2, BN 64)", 36, 25088, 64, 64),
    ("vgg16 conv8 (K2)", 36, 392, 512, 512),
    ("resnet18 s3b1_conv2 (K1, split K)", 0, 2048, 2304, 256),
]

_PRODUCTS = """      wgmma_tf32<BN>(acc, a_lo[kk], b_hi);          // lo * hi
      wgmma_tf32<BN>(acc, a_hi[kk], b_hi + kLoD);   // hi * lo
"""
_HI_HI = "      wgmma_tf32<BN>(acc, a_hi[kk], b_hi);          // hi * hi\n"
_LO_STORE = """  st_shared_v4(lo, tf32_bits(x0 - __uint_as_float(h0)),
               tf32_bits(x1 - __uint_as_float(h1)),
               tf32_bits(x2 - __uint_as_float(h2)),
               tf32_bits(x3 - __uint_as_float(h3)));
"""
_LOOP_COPY = "      copy(j + kCopyAhead);\n"
_SPLIT_B = ("      TcSlab<BN>::split_b(raw(j), base + (j % kSplitStages) * "
            "T::kSplit, p);\n")
_FRAGS = "    TcSlab<BN>::frags(raw(v), frag_row, frag_col, a_hi, a_lo);\n"
_INT_ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
_CVT_ROUND = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
"""

# name -> (what it shows, [(passage, replacement), ...])
VARIANTS = {
    "one_producer_wg": (
        "one producer warpgroup instead of two",
        [("constexpr int kProducers = 256;",
          "constexpr int kProducers = 128;")]),
    "one_item_per_block": (
        "a block per output tile (and split), not persistent blocks",
        [("const unsigned blocks = static_cast<unsigned>(items < sms ? items "
          ": sms);", "const unsigned blocks = static_cast<unsigned>(items);")]),
    "split_stages_2": (
        "two split stages: the producers one slab ahead of the products "
        "instead of two",
        [("constexpr int kSplitStages = 3;",
          "constexpr int kSplitStages = 2;")]),
    "cvt_rounding": (
        "the TF32 rounding by cvt.rna.tf32.f32 instead of integer operations",
        [(_INT_ROUND, _CVT_ROUND)]),
    "one_product": ("hi * hi alone (plain TF32): drops accuracy",
                    [(_PRODUCTS, "")]),
    "no_lo_store": ("B's lo plane not stored (stale): drops accuracy",
                    [(_LO_STORE, "")]),
    "loads_once": ("copies of the first slabs only: computes garbage",
                   [(_LOOP_COPY, "      cp_async_commit();\n")]),
    "no_split": ("the producers copy but do not split B: computes garbage",
                 [(_SPLIT_B, "")]),
    "no_fragments": ("the consumers load no A fragments: computes garbage",
                     [(_FRAGS, "")]),
    "no_products": ("no wgmma at all: copies, split and fragments alone",
                    [(_PRODUCTS, ""), (_HI_HI, "")]),
}


# K5 (csrc/gemm_i8.cu), route tc_s8: (label, M, K, N)
I8_SHAPES = [
    ("vgg16 conv1 (K5, BN 64)", 401408, 576, 64),
    ("vgg16 conv3 (K5)", 100352, 1152, 128),
    ("vgg16 conv5 (K5)", 25088, 2304, 256),
    ("vgg16 conv8 (K5)", 6272, 4608, 512),
    ("vgg16 conv10 (K5, split K)", 1568, 4608, 512),
    ("resnet18 s1b1_conv1 (K5, BN 64)", 32768, 576, 64),
    ("resnet18 s4b1_conv2 (K5, split K)", 512, 4608, 512),
]

_I8_PRODUCTS = """#pragma unroll
      for (int kk = 0; kk < kTcKSteps; ++kk)
        wgmma_s8<BN>(acc, da0 + off + 2 * kk, db0 + off + 2 * kk);
"""
_I8_TRANSPOSE = """  transpose_i8_kernel<<<dim3(static_cast<unsigned>(cdiv(N, 64)),
                             static_cast<unsigned>(cdiv(K, 64))),
                        256, 0, stream>>>(B, bt, K, N);
"""
_I8_COPY = """      copy_slab<BN>(stage(j), A, Bt, M, K, N, it,
                    it.k_begin + static_cast<int64_t>(s) * kTcBK, p);
"""

# name -> (what it shows, [(passage, replacement), ...]) for gemm_i8.cu
I8_VARIANTS = {
    "one_item_per_block": (
        "a block per output tile (and split), not persistent blocks",
        [("const unsigned blocks = static_cast<unsigned>(items < sms ? items "
          ": sms);",
          "const unsigned blocks = static_cast<unsigned>(items);")]),
    "stages_4": (
        "a ring of four stages, two slabs in flight, instead of five and "
        "three",
        [("constexpr int kStages = 5;", "constexpr int kStages = 4;")]),
    "wait_each_slab": (
        "the consumers wait for each slab's products before the next "
        "slab's, instead of keeping one group in flight",
        [("      wgmma_wait<1>();\n", "      wgmma_wait<0>();\n")]),
    "no_transpose": ("B not transposed: Bt is what the previous run left "
                     "in the workspace",
                     [(_I8_TRANSPOSE, "")]),
    "loads_once": ("copies of the first slabs only: computes garbage",
                   [(_I8_COPY, "      if (j < kStages)\n  " + _I8_COPY)]),
    "no_products": ("no wgmma at all: transpose, copies and epilogue alone",
                    [(_I8_PRODUCTS, "")]),
}

# each kernel: (source, variants); the committed build is "<kernel>"
KERNELS = {"k12": (SOURCE, VARIANTS), "k5": (I8_SOURCE, I8_VARIANTS)}


def variant_source(name: str, kernel: str = "k12") -> str:
    source, table = KERNELS[kernel]
    return variants.replace_passages(source.read_text(), table[name][1],
                                     f"variant {name} of {source.name}")


def _ptxas_notes(log: str) -> list[str]:
    """The tensor-core kernels' registers and spills, and any warning."""
    notes, name = [], None
    for line in log.splitlines():
        if m := re.search(r"entry function '(\w+)'", line):
            name = m.group(1)
        tc = re.search(r"(gemm_tc_kernel|qmm_tc_kernel)ILi(\d+)E", name or "")
        if tc and (m := re.search(r"Used (\d+) registers", line)):
            notes.append(f"{tc.group(1)}<{tc.group(2)}>: {m.group(1)} "
                         f"registers")
        if "warning" in line.lower() or "performance loss" in line.lower():
            notes.append(line.strip())
        if "spill" in line and tc and (
                re.search(r"[1-9]\d* bytes spill", line)):
            notes.append(line.strip())
    return notes


def build(kernels: list[str]) -> dict[str, dict[str, ctypes.CDLL]]:
    """Each kernel's committed source and variants, one nvcc each, all in
    parallel; a variant nvcc refuses is left out with its message.
    Returns kernel -> name -> library ("committed" first)."""
    texts = {}
    for kernel in kernels:
        source, table = KERNELS[kernel]
        texts[f"{kernel}.committed"] = source.read_text()
        for name in table:
            texts[f"{kernel}.{name}"] = variant_source(name, kernel)
    built = variants.compile_sources(texts, OUT_DIR)
    libs = {kernel: {} for kernel in kernels}
    p, i = ctypes.c_void_p, ctypes.c_int64
    for key, (so, log) in built.items():
        kernel, name = key.split(".", 1)
        if so is None:
            if name == "committed":
                raise RuntimeError(f"nvcc failed on {key}:\n{log}")
            print(f"ptxas {key}: nvcc failed, variant left out:\n{log}",
                  flush=True)
            continue
        for note in _ptxas_notes(log):
            print(f"ptxas {key}: {note}", flush=True)
        lib = ctypes.CDLL(str(so))
        if kernel == "k12":
            lib.conv_gemm_f32.argtypes = [p] * 5 + [i] * 6 + [p]
            lib.bmm_f32.argtypes = [p] * 5 + [i] * 7 + [p]
            lib.gemm_f32_workspace.argtypes = [i] * 5
            lib.gemm_f32_workspace.restype = i
        else:
            lib.qmm_i8.argtypes = [p] * 6 + [i] * 5 + [p]
            lib.qmm_i8_workspace.argtypes = [i] * 4
            lib.qmm_i8_workspace.restype = i
            lib.qmm_i8_route.argtypes = [p] * 4 + [i] * 3
        libs[kernel][name] = lib
    return libs


def host_probe(reps: int = 2000) -> None:
    """Host time per call of K5's wrapper and of its parts, at a shape whose
    device work is a few microseconds (64 x 64 x 64, route tc_s8): host
    clock over ``reps`` calls, then one synchronise."""
    import time

    from repro_torch.kernels.gemm.int8 import _DTYPES, qmm_i8

    dev = torch.device("cuda", torch.cuda.current_device())
    m = k = n = 64
    a = torch.ones(m, k, dtype=torch.int8, device=dev)
    b = torch.ones(k, n, dtype=torch.int8, device=dev)
    bias = torch.zeros(n, dtype=torch.int32, device=dev)
    mult = torch.ones(n, device=dev)
    out = torch.empty(m, n, dtype=torch.int8, device=dev)
    ws = common.qmm_workspace(m, k, n, dev)
    lib = common.library()
    ptrs = (a.data_ptr(), b.data_ptr(), bias.data_ptr(), mult.data_ptr(),
            out.data_ptr(), ws.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def enter_device():
        with torch.cuda.device(dev):
            pass

    parts = {
        "wrapper qmm_i8 (all of it)": lambda: qmm_i8(a, b, bias, mult, True),
        "library call alone (ctypes, three launches)": lambda: lib.qmm_i8(
            *ptrs, m, k, n, 1, dev.index, stream),
        "operand checks (on_cpu)": lambda: common.on_cpu(
            "qmm_i8", a, b, bias, mult, dtypes=_DTYPES),
        "output and workspace (two torch.empty)": lambda: (
            torch.empty((m, n), dtype=torch.int8, device=dev),
            common.qmm_workspace(m, k, n, dev)),
        "device context (torch.cuda.device)": enter_device,
        "stream handle (current_stream)": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
    }
    for label, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / reps * 1e6
        print(f"host {label}: {us:.1f} us a call", flush=True)


def run_i8(libs: dict[str, ctypes.CDLL], reps: int) -> None:
    """K5's tc_s8 body and its variants at the I8_SHAPES, and the wrapper
    (``qmm_i8``: host checks, allocation, launch) beside them; the
    committed kernel must equal the plain version bit for bit and take
    tc_s8."""
    from repro_torch.kernels.gemm.int8 import qmm_i8, qmm_ref

    names = list(libs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, m, k, n in I8_SHAPES:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=gen)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                          generator=gen)
        bias = torch.randint(-20000, 20000, (n,), dtype=torch.int32,
                             device="cuda", generator=gen)
        mult = (torch.rand(n, generator=gen, device="cuda") + 0.5) / (
            127.0 * k ** 0.5)
        out = torch.empty(m, n, dtype=torch.int8, device="cuda")
        ref = qmm_ref(a, b, bias, mult, True)
        ops, nbytes = 2.0 * m * k * n, m * k + k * n + m * n + 8.0 * n
        floor = max(ops / PEAK_INT8, nbytes / PEAK_HBM) * 1e3
        lib_ms = variants.time_ms(lambda: torch._int_mm(a, b), reps)
        wrapper_ms = variants.time_ms(lambda: qmm_i8(a, b, bias, mult, True),
                                      reps)
        print(f"{label}: (M {m}, K {k}, N {n}); floors: int8 operations "
              f"{ops / PEAK_INT8 * 1e3:.4f} ms, bytes "
              f"{nbytes / PEAK_HBM * 1e3:.4f} ms; torch._int_mm "
              f"{lib_ms:.4f} ms; the wrapper qmm_i8 {wrapper_ms:.4f} ms",
              flush=True)

        # every variant plans as the committed kernel does
        ws = torch.empty(libs["committed"].qmm_i8_workspace(m, k, n, 0),
                         dtype=torch.int32, device="cuda")
        ptrs = (a.data_ptr(), b.data_ptr(), bias.data_ptr(), mult.data_ptr(),
                out.data_ptr(), ws.data_ptr())

        def run(lib):
            err = lib.qmm_i8(*ptrs, m, k, n, 1, 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed ({err})")

        for name in [*names, "committed"]:
            run(libs[name])
            route = common.QMM_ROUTES[libs[name].qmm_i8_route(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), m,
                k, n)]
            torch.cuda.synchronize()
            wrong = int((out != ref).sum())
            if name == "committed" and (wrong or route != "tc_s8"):
                raise AssertionError(f"{label}: route {route}, {wrong} "
                                     f"elements differ from the plain "
                                     f"version")
            ms = variants.time_ms(lambda: run(libs[name]), reps)
            what = (I8_VARIANTS[name][0] if name in I8_VARIANTS
                    else "as committed")
            print(f"  {name}: {ms:.4f} ms, {nbytes / ms * 1e-9:.2f} TB/s, "
                  f"{ops / ms * 1e-9:.1f} TOP/s useful, {floor / ms:.1%} of "
                  f"the floor; {wrong} elements differ ({what})", flush=True)
        del a, b, out, ref, ws
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=sorted(KERNELS), default=None,
                    help="one kernel's breakdown (default: both)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    all_libs = build([args.only] if args.only else list(KERNELS))
    if "k5" in all_libs:
        run_i8(all_libs["k5"], args.reps)
        host_probe()
    if "k12" not in all_libs:
        return 0
    libs = all_libs["k12"]
    names = list(libs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    for label, g, m, k, n in SHAPES:
        gg = max(g, 1)
        a = torch.randn(gg, m, k, device="cuda", generator=gen)
        b = torch.randn(gg, k, n, device="cuda", generator=gen)
        bias = torch.randn(n if g == 0 else gg * n, device="cuda",
                           generator=gen)
        out = torch.empty(gg, m, n, device="cuda")
        if g == 0:
            ref = torch.relu(torch.addmm(bias, a[0], b[0]))[None]
            library = lambda: torch.addmm(bias, a[0], b[0])  # noqa: E731
        else:
            ref = torch.bmm(a, b)
            library = lambda: torch.bmm(a, b)  # noqa: E731
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        ops, nbytes = 2.0 * gg * m * k * n, 4.0 * gg * (m * k + k * n + m * n)
        fma_floor = max(ops / PEAK_FP32, nbytes / PEAK_HBM) * 1e3
        tc_floor = max(3 * ops / PEAK_TF32, nbytes / PEAK_HBM) * 1e3
        print(f"{label}: (G {gg}, M {m}, K {k}, N {n}); floors: fp32 FMA "
              f"{fma_floor:.4f} ms, 3xTF32 {tc_floor:.4f} ms; library "
              f"{variants.time_ms(library, args.reps):.4f} ms", flush=True)

        def run(lib):
            size = lib.gemm_f32_workspace(gg, m, k, n, 0)
            ws = (torch.empty(size, device="cuda") if size else None)
            wp = None if ws is None else ws.data_ptr()
            if g == 0:
                err = lib.conv_gemm_f32(a.data_ptr(), b.data_ptr(),
                                        bias.data_ptr(), out.data_ptr(), wp,
                                        m, k, n, 1, 0, 0, stream)
            else:
                err = lib.bmm_f32(a.data_ptr(), b.data_ptr(), None,
                                  out.data_ptr(), wp, g, m, k, n, 0, 0, 0,
                                  stream)
            if err != 0:
                raise RuntimeError(f"launch failed ({err})")

        for name in [*names, "committed"]:
            run(libs[name])
            torch.cuda.synchronize()
            diff = float((out - ref).abs().max())
            ms = variants.time_ms(lambda: run(libs[name]), args.reps)
            what = VARIANTS[name][0] if name in VARIANTS else "as committed"
            print(f"  {name}: {ms:.4f} ms, {ops / ms * 1e-9:.1f} TFLOP/s "
                  f"useful, max|diff| {diff:.2e} (tolerance {tol:.2e}; "
                  f"{what})", flush=True)
        del a, b, out, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
