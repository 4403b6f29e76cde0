"""Where K6's time goes on the card: the bf16 kernel against variants of it.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.breakdown

Each variant is ``csrc/flash_attention.cu`` with a few passages replaced:
either one design choice of the kernel undone (to show what it is worth) or
one part of the work dropped (to show what it costs). The variants are built
with ``nvcc`` in parallel into ``build/repro_torch/k6_variants/``, then run
at the LM prefill shape (full-width minitron-8b: 64 query heads, GQA 4:1,
Sq 4096, Skv 4112, D 128, bf16, causal) in turns, the committed kernel
first and last. For each: the median CUDA-event time, the useful TFLOP/s
(4 D operations per unmasked pair) and the worst element's share of one
bf16 step of the plain version. A variant that drops work computes
something else, so its worst element is printed, not checked. A passage
that is no longer in the source raises: the variants follow the kernel.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import struct
import subprocess

import torch

from repro_torch.kernels import common, variants
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = common.CSRC_DIR / "flash_attention.cu"
OUT_DIR = common.BUILD_DIR / "k6_variants"

_TURN_SYNC = ('if (wg == 1) asm volatile("bar.sync 1, %0;\\n" '
              '::"n"(kTcThreads) : "memory");')
_TURN_ARRIVE = ('if (wg == 0) asm volatile("bar.arrive 1, %0;\\n" '
                '::"n"(kTcThreads) : "memory");')
_NO_TURNS = [(_TURN_SYNC, ""), (_TURN_ARRIVE, "")]
_WG1_COPIES = "    if (wg == 1) prefetch(kb);\n"
_WG0_COPIES = "    if (wg == 0) prefetch(kb);"
_MASK_NOW = """#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale;
    if (c0 + kTileKV > kv_len ||
        (causal && c0 + kTileKV - 1 > wg_row0 + row_offset)) {"""
# the first version: a 64-bit test of every element, which the compiler
# turned into selects run on every step
_MASK_EVERY_STEP = """    const bool masked = c0 + kTileKV > kv_len ||
                        (causal && c0 + kTileKV - 1 > wg_row0 + row_offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (masked) {
        const int64_t col = c0 + 8 * (i / 4) + col_t + (i % 2);
        const int64_t row = row_a + 8 * ((i / 2) % 2);
        if (col >= kv_len || (causal && col > row + row_offset)) x = kNegInf;
      }
      s[i] = x;
    }
    if (false) {"""
_PV_TERMS = "for (int t = 0; t < 3; ++t) wgmma_rs<DP>"

# name -> (what it shows, [(passage, replacement), ...]); a passage of None
# replaces every "expf(" call
VARIANTS = {
    "no_turns": (
        "both warpgroups queue their products at once (no turns)",
        _NO_TURNS + [(_WG1_COPIES, ""), (_WG0_COPIES, "    prefetch(kb);")]),
    "copies_first": (
        "no turns, and the next tile's copies started before the products",
        _NO_TURNS + [(_WG1_COPIES, "    prefetch(kb);\n"), (_WG0_COPIES, "")]),
    "mask_every_step": (
        "the first mask: a 64-bit test of every element",
        [(_MASK_NOW, _MASK_EVERY_STEP)]),
    "exp_fast": ("__expf (ex2.approx) for exp: drops accuracy",
                 [(None, "__expf(")]),
    "p_terms_2": ("P in two bf16 terms: misses one bf16 step",
                  [(_PV_TERMS, _PV_TERMS.replace("t < 3", "t < 2"))]),
    "p_terms_1": ("P in one bf16 term (P V as SDPA rounds it)",
                  [(_PV_TERMS, _PV_TERMS.replace("t < 3", "t < 1"))]),
    "no_pv": ("no P V product at all",
              [(_PV_TERMS, _PV_TERMS.replace("t < 3", "t < 0"))]),
}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    passages = VARIANTS[name][1]
    for passage, replacement in passages:
        if passage is None:
            src = src.replace("expf(", replacement)
    return variants.replace_passages(
        src, [p for p in passages if p[0] is not None],
        f"variant {name} of {SOURCE.name}")


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    """The committed source and each variant, one nvcc each, in parallel."""
    built = variants.compile_sources(
        {name: SOURCE.read_text() if name == "committed"
         else variant_source(name) for name in names}, OUT_DIR)
    libs = {}
    for name, (so, log) in built.items():
        if so is None:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
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
    names = ["committed", *VARIANTS]
    libs = build(names)

    bh, group, sq, skv, d = 64, 4, 4096, 4112, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(bh, sq, d, device="cuda", generator=gen).bfloat16()
    k = torch.randn(bh // group, skv, d, device="cuda",
                    generator=gen).bfloat16()
    v = torch.randn(bh // group, skv, d, device="cuda",
                    generator=gen).bfloat16()
    ref = flash_attention_ref(q, k, v).float()
    lim = 2.0 ** -7 * ref.abs() + 1e-6
    scale_bits = struct.unpack("<I", struct.pack("<f", d ** -0.5))[0]
    ops = 4.0 * d * bh * sum(min(i + 1, skv) for i in range(sq))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), bh, group, sq, skv, d, skv,
                                  1, 1, scale_bits, 0, 0, stream)
        if err != 0:
            raise RuntimeError(f"launch failed ({err})")

    for name in [*names, "committed"]:
        run(libs[name])
        torch.cuda.synchronize()
        ratio = float(((out.float() - ref).abs() / lim).max())
        ms = variants.time_ms(lambda: run(libs[name]), args.reps)
        what = VARIANTS[name][0] if name in VARIANTS else "as committed"
        print(f"{name}: {ms:.3f} ms, {ops / ms * 1e-9:.1f} TFLOP/s useful, "
              f"worst element {ratio:.3f} of one bf16 step ({what})",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
