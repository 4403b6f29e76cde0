"""Chip smoke test: the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version at every shape the main path
gives it (and times kernel, plain version and the nearest single PyTorch
call), then serves batch-8, 224x224, 1000-class VGG16 through
``repro_torch.api.Accelerator`` with ``backend="hopper"``: one first request
and several steady ones, with the kernel launch counts checked per request
and the logits held against the ``backend="torch"`` (aten) accelerator on
the same card. Any failure raises and exits non-zero; without a CUDA card,
or without the repository beside it, the script exits non-zero before
printing any result.

Output: the card's name and power limit, one JSON line per (kernel, shape),
the main-path timings, a ``{"kernels": [...]}`` summary line, and as the last
line ``{"ok": true, "device": {...}}``.
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
# cores, and HBM3 bandwidth; they assume the 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BATCH, IMG, N_CLASSES = 8, 224, 1000
STEADY_REQUESTS = 10
KERNEL_REPS = 10
# per-request launches on the main path: 9 Spatial CONVs (K1); 4 Winograd
# GEMMs + 3 FC (K2); 4 Winograd CONVs (K3, K4)
EXPECTED_PER_REQUEST = {"conv_gemm_f32": 9, "bmm_f32": 7,
                        "wino_input_transform_f32": 4,
                        "wino_output_transform_f32": 4}
SOURCES = {
    "conv_gemm_f32": ("src/repro_torch/csrc/gemm_f32.cu",
                      "src/repro/kernels/spatial_conv/kernel.py:51"),
    "bmm_f32": ("src/repro_torch/csrc/gemm_f32.cu",
                "src/repro/kernels/gemm/kernel.py:68"),
    "wino_input_transform_f32": ("src/repro_torch/csrc/winograd_f32.cu",
                                 "src/repro/kernels/winograd/kernel.py:52"),
    "wino_output_transform_f32": ("src/repro_torch/csrc/winograd_f32.cu",
                                  "src/repro/kernels/winograd/kernel.py:82"),
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
            base = re.search(r"(gemm_f32_kernel|splitk_reduce_kernel|"
                             r"wino_input_kernel|wino_output_kernel)", mangled)
            args = [a or b for a, b in re.findall(r"Li(\d+)E|Lb(\d)E",
                                                   mangled)]
            name = (base.group(1) if base else mangled) + (
                f"<{','.join(args)}>" if args else "")
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       f"spilled")
            name, spill = None, "?"
    return out


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_cases(program, batch: int):
    """Every kernel call the main path makes per request, with its shapes:
    ``(kernel, layer name, shape dict, launches)``, one entry per layer."""
    from repro_torch.core.winograd import pt_for
    from repro_torch.kernels.common import cdiv
    cases = []
    for cl in program.layers:
        s = cl.spec
        if cl.kind == "fc":
            cases.append(("bmm_f32", s.name, dict(
                g=1, m=batch, k=s.d_in, n=s.d_out, df="is"), 1))
        elif cl.kind == "conv" and cl.plan.mode == "spat":
            ho, wo = s.out_hw
            cases.append(("conv_gemm_f32", s.name, dict(
                t=batch * ho * wo, crs=s.r * s.s * s.c, k=s.k,
                df=cl.plan.dataflow), 1))
        elif cl.kind == "conv":
            m = cl.plan.m
            ho, wo = s.out_hw
            t = batch * cdiv(ho, m) * cdiv(wo, m)
            pt2 = pt_for(m) ** 2
            cases.append(("wino_input_transform_f32", s.name,
                          dict(t=t, c=s.c, m=m), 1))
            cases.append(("bmm_f32", s.name, dict(
                g=pt2, m=t, k=s.c, n=s.k, df=cl.plan.dataflow), 1))
            cases.append(("wino_output_transform_f32", s.name,
                          dict(t=t, k=s.k, m=m), 1))
    return cases


def run_case(name: str, shape: dict, gen: torch.Generator) -> dict:
    """Kernel vs plain version on the card at one shape; times all three."""
    from repro_torch.kernels.gemm.kernel import bmm_f32, bmm_ref
    from repro_torch.kernels.spatial_conv.kernel import (
        conv_gemm_f32,
        conv_gemm_ref,
    )
    from repro_torch.kernels.winograd.kernel import (
        wino_input_transform_f32,
        wino_input_transform_ref,
        wino_output_transform_f32,
        wino_output_transform_ref,
    )

    def rnd(*size):
        return torch.randn(*size, generator=gen, device="cuda")

    lib = None
    if name == "conv_gemm_f32":
        t, crs, k, df = shape["t"], shape["crs"], shape["k"], shape["df"]
        p, w, b = rnd(t, crs), rnd(crs, k), rnd(k)
        kern = lambda: conv_gemm_f32(p, w, b, True, df)
        plain = lambda: conv_gemm_ref(p, w, b, True, df)
        lib = lambda: torch.addmm(b, p, w)   # bias + GEMM (ReLU not fused)
        flops = 2.0 * t * crs * k
        nbytes = 4.0 * (t * crs + crs * k + k + t * k)
    elif name == "bmm_f32":
        g, m, k, n, df = (shape[x] for x in ("g", "m", "k", "n", "df"))
        a, bm = rnd(g, m, k), rnd(g, k, n)
        kern = lambda: bmm_f32(a, bm, None, False, df)
        plain = lambda: bmm_ref(a, bm, None, False, df)
        lib = lambda: torch.bmm(a, bm)
        flops = 2.0 * g * m * k * n
        nbytes = 4.0 * (g * m * k + g * k * n + g * m * n)
    elif name == "wino_input_transform_f32":
        t, c, m = shape["t"], shape["c"], shape["m"]
        pt = m + 2
        d = rnd(t, pt, pt, c)
        kern = lambda: wino_input_transform_f32(d, m)
        plain = lambda: wino_input_transform_ref(d, m)
        flops = 4.0 * pt ** 3 * t * c        # B^T d and (B^T d) B, dense
        nbytes = 4.0 * 2 * t * pt * pt * c
    else:
        t, k, m = shape["t"], shape["k"], shape["m"]
        pt = m + 2
        mm, b = rnd(pt * pt, t, k), rnd(k)
        kern = lambda: wino_output_transform_f32(mm, b, m, True)
        plain = lambda: wino_output_transform_ref(mm, b, m, True)
        flops = 2.0 * (m * pt * pt + m * m * pt) * t * k
        nbytes = 4.0 * (pt * pt * t * k + k + t * m * m * k)
    y, y_ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    scale = max(1.0, float(y_ref.abs().max()))
    tol = 1e-4 * scale
    if not err <= tol:
        raise AssertionError(f"{name} {shape}: max|diff| {err:.3e} > {tol:.3e}")
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(max_abs_err=err, tol=tol, ms=time_ms(kern),
                plain_ms=time_ms(plain),
                library_ms=None if lib is None else time_ms(lib),
                bound_ms=bound_ms, bound_by=bound_by)


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
    from repro_torch import api
    from repro_torch.compat import use_strict_fp32
    from repro_torch.core import perf_model as pm
    from repro_torch.core.compiler import compile_network
    from repro_torch.kernels import common
    from repro_torch.models import vgg

    # -- phase 1: card, numerics, build ---------------------------------------
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

    # -- phase 2: every kernel at every main-path shape vs its plain version --
    specs = vgg.network_specs(IMG, 1, n_classes=N_CLASSES)
    program = compile_network(specs, pm.V5E.run_dse(specs, batch=BATCH).plans)
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                             bound_ms=0.0, library_ms=None, bound_by={})
                  for name in common.KERNELS}
    seen: dict[tuple, dict] = {}
    for name, layer, shape, n in kernel_cases(program, BATCH):
        key = (name, tuple(sorted(shape.items())))
        if key not in seen:
            seen[key] = run_case(name, shape, gen)
            torch.cuda.empty_cache()
        r = seen[key]
        print(json.dumps({"kernel": name, "layer": layer, **shape, **r}),
              flush=True)
        agg = per_kernel[name]
        agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
        for f in ("ms", "plain_ms", "bound_ms"):
            agg[f] += n * r[f]
        if r["library_ms"] is not None:
            agg["library_ms"] = (agg["library_ms"] or 0.0) + n * r["library_ms"]
        agg["bound_by"][r["bound_by"]] = (agg["bound_by"].get(r["bound_by"], 0)
                                          + n * r["bound_ms"])

    # -- phase 3: the main path through the user's entry points --------------
    t0 = time.perf_counter()
    acc = api.Accelerator.build(specs, pm.V5E, batch=BATCH, backend="hopper",
                                device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (BATCH, IMG, IMG, 3)).astype(np.float32)).cuda()
    n_requests = 1 + STEADY_REQUESTS

    common.reset_launches()
    t0 = time.perf_counter()
    y = acc(x)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    first_counts = dict(common.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(STEADY_REQUESTS):
        y = acc(x)
    torch.cuda.synchronize()
    t_steady = (time.perf_counter() - t0) / STEADY_REQUESTS
    launches = dict(common.LAUNCHES)

    if first_counts != EXPECTED_PER_REQUEST:
        raise AssertionError(f"launches per request {first_counts} != "
                             f"{EXPECTED_PER_REQUEST}")
    for name, per in EXPECTED_PER_REQUEST.items():
        if launches[name] != per * n_requests:
            raise AssertionError(f"{name}: {launches[name]} launches over "
                                 f"{n_requests} requests, want "
                                 f"{per * n_requests}")
    modes = [f"{cl.spec.name}:{cl.plan.mode}" for cl in acc.program.layers
             if cl.kind == "conv"]
    print(f"main path: VGG16 {IMG}x{IMG} batch {BATCH}, "
          f"{acc.n_instructions} instructions, CONV modes {modes}; "
          f"build {t_build * 1e3:.0f}ms; first request "
          f"{t_first * 1e3:.1f}ms; steady {t_steady * 1e3:.2f}ms/batch "
          f"({BATCH / t_steady:.1f} images/s) over {STEADY_REQUESTS} "
          f"requests; launches per request {first_counts}", flush=True)

    y_np = y.cpu().numpy()
    if y_np.shape != (BATCH, N_CLASSES) or not np.isfinite(y_np).all():
        raise AssertionError(f"logits shape {y_np.shape} or non-finite values")
    acc_ref = api.Accelerator.build(specs, pm.V5E, batch=BATCH,
                                    backend="torch", params=acc.params,
                                    device="cuda")
    y_ref = acc_ref(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEADY_REQUESTS):
        y_ref = acc_ref(x)
    torch.cuda.synchronize()
    t_ref = (time.perf_counter() - t0) / STEADY_REQUESTS
    ref_np = y_ref.cpu().numpy()
    err = float(np.abs(y_np - ref_np).max())
    tol = 1e-3 * float(np.abs(ref_np).max())
    if not err <= tol:
        raise AssertionError(f"hopper vs torch logits: max|diff| {err:.3e} > "
                             f"{tol:.3e}")
    print(f"logits vs backend='torch' on the card: max|diff| {err:.3e} "
          f"(tolerance 1e-3 * max|logit| = {tol:.3e}); torch backend steady "
          f"{t_ref * 1e3:.2f}ms/batch ({BATCH / t_ref:.1f} images/s)",
          flush=True)
    kernel_ms = sum(a["ms"] for a in per_kernel.values())
    print(f"kernel time per request (phase 2 sums): {kernel_ms:.2f}ms of "
          f"{t_steady * 1e3:.2f}ms/batch", flush=True)

    summary = []
    for name in common.KERNELS:
        a = per_kernel[name]
        source, replaces = SOURCES[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
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
