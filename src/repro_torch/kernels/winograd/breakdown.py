"""Where the Winograd transforms' time goes on the card: K3 and K4 at every
Winograd layer of the two CNN paths, called directly and through their
wrappers, beside variants of themselves, and the host time of a launch.

    PYTHONPATH=src python -m repro_torch.kernels.winograd.breakdown

The layers are those of the VGG16 (224x224) and ResNet-18 (128x128) fp32
paths at batch 8 under ``pm.V5E`` plans, at the NHWC geometry the executor
gives them (the slab's vertical pad materialized, the width pad passed as
geometry). Each variant is ``csrc/winograd_f32.cu`` with a few passages
replaced, built with ``nvcc`` in parallel into
``build/repro_torch/winograd_variants/``:

* ``direct``: K3 without the shared-memory window; each thread reads its
  tile's values with float4 loads from device memory and leaves the
  2-pixel overlap to L1/L2;
* ``scalar``: both kernels on their scalar route (one thread per tile and
  channel, scalar loads and stores);
* ``strip16``: K3 blocks of 16 output columns instead of 32 (half the
  window, twice the blocks);
* ``lanes8``: both kernels' blocks 32 channels wide instead of 64;
* ``out_tiles4``, ``out_tiles16``: K4 blocks of 4 or 16 tiles instead
  of 8.

For each layer and kernel: the median CUDA-event time of the committed
kernel called directly, then through its wrapper (operand checks,
allocation, launch), and of each variant called directly (the committed
kernel first and last), each beside its device time from
``torch.profiler`` (the event time holds the launch too where the kernel is
shorter than its host path); the bytes bound at 3.35 TB/s; the largest
difference from the plain version. Then the host probe: host time per call
of the wrappers and of their parts at shapes whose device work is a few
microseconds, K5's wrapper included, and of the device context the launch
path no longer enters. A passage that is no longer in the source raises:
the variants follow the kernel. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import time

import torch

from repro_torch.kernels import common, variants
from repro_torch.kernels.winograd.kernel import (
    wino_grid,
    wino_input_transform_f32,
    wino_input_transform_nhwc_f32,
    wino_input_transform_nhwc_ref,
    wino_output_transform_nhwc_f32,
    wino_output_transform_nhwc_ref,
)

SOURCE = common.CSRC_DIR / "winograd_f32.cu"
OUT_DIR = common.BUILD_DIR / "winograd_variants"
PEAK_HBM = 3.35e12
BATCH = 8

_STAGE_BEGIN = "  // stage the window;"
_STAGE_END = "  // (B^T d) B for tile j"
_WINDOW_READ = ("    for (int q = 0; q < PT; ++q)\n"
                "      r[q] = win[i * kRow + (j * M + q) * kLanes + l];\n")
_DIRECT_READ = """    for (int q = 0; q < PT; ++q) {
      const int64_t xx = x0 + j * M + q;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        const int64_t yy = y0 + p;
        if (yy >= 0 && yy < g.h && xx >= 0 && xx < g.w)
          axpy(s, Wino<M>::bt(i, p), __ldg(reinterpret_cast<const float4*>(
                                         img + (yy * g.w + xx) * g.c + cc)));
      }
      r[q] = s;
    }
"""
_VEC_TEST = """  return channels % 4 == 0 && aligned16(a) && aligned16(b) &&
         (c == nullptr || aligned16(c));
"""


def _passage(text: str, begin: str, end: str) -> str:
    """The text from ``begin`` up to (not including) ``end``."""
    i = text.index(begin)
    return text[i:text.index(end, i)]


def _variants(text: str) -> dict[str, tuple[str, list]]:
    """name -> (what it shows, [(passage, replacement), ...])"""
    return {
        "direct": (
            "K3 reads its tile from device memory with float4 loads, no "
            "shared-memory window (L1/L2 serve the overlap)",
            [(_passage(text, _STAGE_BEGIN, _STAGE_END), ""),
             (_WINDOW_READ, _DIRECT_READ),
             ("         S::kThreads, S::kSmem, s>>>(x, v, g);",
              "         S::kThreads, 0, s>>>(x, v, g);")]),
        "scalar": ("both kernels on the scalar route",
                   [(_VEC_TEST, "  return false;\n")]),
        "strip16": ("K3 blocks of 16 output columns, not 32",
                    [("constexpr int kStripCols = 32;",
                      "constexpr int kStripCols = 16;")]),
        "lanes8": ("K3 and K4 blocks 32 channels wide, not 64",
                   [("constexpr int kLanes = 16;",
                     "constexpr int kLanes = 8;")]),
        "out_tiles4": ("K4 blocks of 4 tiles, not 8",
                       [("constexpr int kOutTiles = 8;",
                         "constexpr int kOutTiles = 4;")]),
        "out_tiles16": ("K4 blocks of 16 tiles, not 8",
                        [("constexpr int kOutTiles = 8;",
                          "constexpr int kOutTiles = 16;")]),
    }


def build() -> dict[str, ctypes.CDLL]:
    """The committed source and its variants, one nvcc each, in parallel;
    name -> library ("committed" first)."""
    text = SOURCE.read_text()
    texts = {"committed": text}
    for name, (_, passages) in _variants(text).items():
        texts[name] = variants.replace_passages(
            text, passages, f"variant {name} of {SOURCE.name}")
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int64
    for name, (so, log) in variants.compile_sources(texts, OUT_DIR).items():
        if so is None:
            if name == "committed":
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            print(f"ptxas {name}: nvcc failed, variant left out:\n{log}",
                  flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        lib.wino_input_transform_f32.argtypes = [p] * 2 + [i] * 10 + [p]
        lib.wino_output_transform_f32.argtypes = [p] * 3 + [i] * 9 + [p]
        libs[name] = lib
    return libs


def winograd_layers() -> list[tuple[str, dict]]:
    """Every Winograd layer of the two fp32 paths: (label, geometry), the
    geometry as the executor's fused lowering gives it to K3 and K4."""
    from repro_torch.core import perf_model as pm
    from repro_torch.core.compiler import compile_network
    from repro_torch.core.executor import width_pad
    from repro_torch.models import resnet, vgg

    layers = []
    for path, specs in (
            ("vgg16", vgg.network_specs(224, 1, n_classes=1000)),
            ("resnet18", resnet.resnet18_specs(128, 1, n_classes=1000))):
        program = compile_network(specs, pm.V5E.run_dse(
            specs, batch=BATCH, dtype="float32").plans)
        for cl in program.layers:
            if cl.kind == "conv" and cl.plan.mode == "wino":
                ho, wo = cl.spec.out_hw
                layers.append((f"{path} {cl.spec.name}", dict(
                    n=BATCH, h=ho + 2, w=cl.spec.w, c=cl.spec.c, k=cl.spec.k,
                    m=cl.plan.m, pad=((0, 0), width_pad(cl)))))
    return layers


def run_layer(libs: dict[str, ctypes.CDLL], label: str, geom: dict,
              reps: int) -> None:
    n, h, w, c, k, m, pad = (geom[x] for x in
                             ("n", "h", "w", "c", "k", "m", "pad"))
    pt = m + 2
    ho, wo, nh, nw = wino_grid(h, w, m, pad)
    t = n * nh * nw
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    mm = torch.randn(pt * pt, t, k, device="cuda", generator=gen)
    bias = torch.randn(k, device="cuda", generator=gen)
    v = torch.empty(pt * pt, t, c, device="cuda")
    y = torch.empty(n, ho, wo, k, device="cuda")
    v_ref = wino_input_transform_nhwc_ref(x, m, pad)
    y_ref = wino_output_transform_nhwc_ref(mm, bias, m, (n, ho, wo), True)
    stream = torch.cuda.current_stream().cuda_stream
    (top, _), (left, _) = pad
    k3_bytes = 4.0 * (n * h * w * c + pt * pt * t * c)
    k4_bytes = 4.0 * (pt * pt * t * k + k + n * ho * wo * k)

    def k3(lib):
        err = lib.wino_input_transform_f32(
            x.data_ptr(), v.data_ptr(), n, h, w, c, top, left, nh, nw, m, 0,
            stream)
        if err != 0:
            raise RuntimeError(f"K3 launch failed ({err})")

    def k4(lib):
        err = lib.wino_output_transform_f32(
            mm.data_ptr(), bias.data_ptr(), y.data_ptr(), n, ho, wo, k, nh,
            nw, m, 1, 0, stream)
        if err != 0:
            raise RuntimeError(f"K4 launch failed ({err})")

    print(f"{label}: x ({n}, {h}, {w}, {c}), pads {pad}, m {m}, {t} tiles, "
          f"K {k}", flush=True)
    for kernel, call, out, ref, nbytes, wrapper in (
            ("K3", k3, v, v_ref, k3_bytes,
             lambda: wino_input_transform_nhwc_f32(x, m, pad)),
            ("K4", k4, y, y_ref, k4_bytes,
             lambda: wino_output_transform_nhwc_f32(mm, bias, m, (n, ho, wo),
                                                    True))):
        floor = nbytes / PEAK_HBM * 1e3
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        wrapper_ms = variants.time_ms(wrapper, reps)
        print(f"  {kernel}: bytes bound {floor:.4f} ms; through the wrapper "
              f"{wrapper_ms:.4f} ms (events)", flush=True)
        for name in [*libs, "committed"]:
            call(libs[name])
            torch.cuda.synchronize()
            diff = float((out - ref).abs().max())
            if name == "committed" and not diff <= tol:
                raise AssertionError(f"{label} {kernel}: max|diff| {diff:.2e}"
                                     f" > {tol:.2e}")
            ms = variants.time_ms(lambda: call(libs[name]), reps)
            dev = variants.device_ms(lambda: call(libs[name]), reps)
            what = "as committed"
            if name != "committed":
                what = _variants(SOURCE.read_text())[name][0]
            on_device = ("device not measured" if dev is None else
                         f"device {dev:.4f} ms, {nbytes / dev * 1e-9:.2f} "
                         f"TB/s, {floor / dev:.1%} of the bound")
            print(f"    {name}: {ms:.4f} ms a call (events); {on_device}; "
                  f"max|diff| {diff:.2e} (tolerance {tol:.2e}; {what})",
                  flush=True)
    del x, mm, v, y, v_ref, y_ref
    torch.cuda.empty_cache()


def host_probe(reps: int = 2000) -> None:
    """Host time per call of the K3/K4 wrappers and of K5's, and of their
    parts, at shapes whose device work is a few microseconds: host clock
    over ``reps`` calls, then one synchronise."""
    from repro_torch.kernels.gemm.int8 import qmm_i8

    dev = torch.device("cuda", torch.cuda.current_device())
    m = 4
    x = torch.ones(1, 6, 6, 64, device=dev)
    tiles = torch.ones(1, 6, 6, 64, device=dev)
    mm = torch.ones(36, 1, 64, device=dev)
    bias = torch.zeros(64, device=dev)
    v = torch.empty(36, 1, 64, device=dev)
    lib = common.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    a8 = torch.ones(64, 64, dtype=torch.int8, device=dev)
    b8 = torch.ones(64, 64, dtype=torch.int8, device=dev)
    bias8 = torch.zeros(64, dtype=torch.int32, device=dev)
    mult = torch.ones(64, device=dev)

    def enter_device():
        with torch.cuda.device(dev):
            pass

    parts = {
        "K3 wrapper, NHWC front (all of it)":
            lambda: wino_input_transform_nhwc_f32(x, m, ((0, 0), (0, 0))),
        "K3 wrapper, tiles front (all of it)":
            lambda: wino_input_transform_f32(tiles, m),
        "K4 wrapper, NHWC front (all of it)":
            lambda: wino_output_transform_nhwc_f32(mm, bias, m, (1, 4, 4),
                                                   True),
        "K5 wrapper qmm_i8 (all of it)":
            lambda: qmm_i8(a8, b8, bias8, mult, True),
        "common.launch of K3 (no checks, no allocation)":
            lambda: common.launch("wino_input_transform_f32", [x, v],
                                  [1, 6, 6, 64, 0, 0, 1, 1, m]),
        "K3 library call alone (ctypes, one launch)":
            lambda: lib.wino_input_transform_f32(
                x.data_ptr(), v.data_ptr(), 1, 6, 6, 64, 0, 0, 1, 1, m,
                dev.index, stream),
        "operand checks (on_cpu)":
            lambda: common.on_cpu("wino_input_transform_f32", x),
        "output (one torch.empty)":
            lambda: torch.empty((36, 1, 64), device=dev),
        "stream handle (current_stream), no longer taken":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream handle (as common.launch takes it)":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "device context (torch.cuda.device), no longer entered":
            enter_device,
    }
    before = dict(common.LAUNCHES)
    for label, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / reps * 1e6
        print(f"host {label}: {us:.1f} us a call", flush=True)
    common.LAUNCHES.update(before)


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
    libs = build()
    seen = set()
    for label, geom in winograd_layers():
        key = tuple(sorted((k, str(v)) for k, v in geom.items()))
        if key in seen:
            print(f"{label}: as above", flush=True)
            continue
        seen.add(key)
        run_layer(libs, label, geom, args.reps)
    host_probe()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
