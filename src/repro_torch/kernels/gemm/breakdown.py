"""Where K1/K2's tensor-core time goes on the card: the 3xTF32 body against
variants of it.

    PYTHONPATH=src python -m repro_torch.kernels.gemm.breakdown

Each variant is ``csrc/gemm_f32.cu`` with a few passages replaced: either
one design choice undone (to show what it is worth) or one part of the work
dropped (to show what it costs). The variants are built with ``nvcc`` in
parallel into ``build/repro_torch/gemm_variants/``, then run in turns, the
committed kernel first and last, at main-path shapes of K1 and K2 (VGG16
and ResNet-18 at batch 8) that take the tensor-core route. For each: the
median CUDA-event time per shape and, beside them, ``torch.addmm`` /
``torch.bmm`` on the same operands, and the fp32 FMA-pipe and 3xTF32
floors. A variant that drops work computes something else, so its largest
difference from the plain version is printed, not checked. A passage that
is no longer in the source raises: the variants follow the kernel. The
ptxas notes of each build (registers, spills, serialized ``wgmma``) are
printed too. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess

import torch

from repro_torch.kernels import common, variants

SOURCE = common.CSRC_DIR / "gemm_f32.cu"
OUT_DIR = common.BUILD_DIR / "gemm_variants"
PEAK_FP32, PEAK_TF32, PEAK_HBM = 67e12, 494.7e12, 3.35e12

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


def variant_source(name: str) -> str:
    return variants.replace_passages(SOURCE.read_text(), VARIANTS[name][1],
                                     f"variant {name} of {SOURCE.name}")


def _ptxas_notes(log: str) -> list[str]:
    """The tensor-core kernels' registers and spills, and any warning."""
    notes, name = [], None
    for line in log.splitlines():
        if m := re.search(r"entry function '(\w+)'", line):
            name = m.group(1)
        elif "gemm_tc_kernel" in (name or "") and (
                m := re.search(r"Used (\d+) registers", line)):
            bn = re.search(r"gemm_tc_kernelILi(\d+)E", name)
            notes.append(f"gemm_tc_kernel<{bn.group(1) if bn else '?'}>: "
                         f"{m.group(1)} registers")
        if "warning" in line.lower() or "performance loss" in line.lower():
            notes.append(line.strip())
        if "spill" in line and "gemm_tc_kernel" in (name or "") and (
                re.search(r"[1-9]\d* bytes spill", line)):
            notes.append(line.strip())
    return notes


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    """The committed source and each variant, one nvcc each, in parallel;
    a variant nvcc refuses is left out with its message."""
    built = variants.compile_sources(
        {name: SOURCE.read_text() if name == "committed"
         else variant_source(name) for name in names}, OUT_DIR)
    libs = {}
    for name, (so, log) in built.items():
        if so is None:
            if name == "committed":
                raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{log}")
            print(f"ptxas {name}: nvcc failed, variant left out:\n{log}",
                  flush=True)
            continue
        for note in _ptxas_notes(log):
            print(f"ptxas {name}: {note}", flush=True)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int64
        lib.conv_gemm_f32.argtypes = [p] * 5 + [i] * 6 + [p]
        lib.bmm_f32.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.gemm_f32_workspace.argtypes = [i] * 5
        lib.gemm_f32_workspace.restype = i
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(["committed", *VARIANTS])
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
