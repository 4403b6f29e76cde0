"""CNN serving through the ported HybridDNN pipeline — DSE -> compile ->
validated, cached executor — on a CUDA card by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vgg16 \
      --no-reduced --batch 8 --backend hopper [--dtype int8]

``--arch resnet18`` serves ResNet-18 (``--no-reduced``: the full-width
``resnet18_specs(128, 1, n_classes=1000)``). ``--dtype int8`` calibrates on
the request batch, as the reference does, and serves the int8 accelerator.
``--device cpu`` runs the same flow on the CPU (``hopper`` then runs each
kernel's plain version). Prints the build time (and, for int8, the
calibration time inside it), the first request's time and the steady-state
ms/batch and images/s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

CNN_TARGETS = {"tpu": "V5E", "vu9p": "VU9P", "pynq": "PYNQ_Z1"}
# (img, scale) per arch: reduced, then full width (ResNet-18 at 128: the
# largest power-of-two resolution whose flattened FC input fits the ISA)
SIZES = {"vgg16": ((64, 8), (224, 1)), "resnet18": ((64, 8), (128, 1))}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_cnn(arch: str = "vgg16", *, reduced: bool = True, batch: int = 8,
              iters: int = 20, seed: int = 0, target: str = "tpu",
              backend: str = "torch", opt_level: int = 1,
              dtype: str = "float32", device=None) -> np.ndarray:
    """Build the accelerator, answer one first request and ``iters`` steady
    requests, print the timings and return the last logits."""
    from repro_torch import api
    from repro_torch.core import perf_model as pm
    from repro_torch.models import resnet, vgg

    if arch not in SIZES:
        raise ValueError(f"CNN serving supports 'vgg16' (the paper's case "
                         f"study) and 'resnet18' (the residual workload), "
                         f"got {arch!r}")
    if target not in CNN_TARGETS:
        raise ValueError(f"--target must be one of {sorted(CNN_TARGETS)}")
    iters = max(1, iters)
    img, scale = SIZES[arch][0 if reduced else 1]
    n_classes = 10 if reduced else 1000
    build = (resnet.resnet18_specs if arch == "resnet18"
             else vgg.network_specs)
    specs = build(img, scale, n_classes=n_classes)
    x_np = np.random.default_rng(seed + 1).standard_normal(
        (batch, img, img, 3)).astype(np.float32)

    t0 = time.perf_counter()
    # int8 calibrates on the request distribution itself, the serving analog
    # of calibrating on a training-set slice
    acc = api.Accelerator.build(
        specs, getattr(pm, CNN_TARGETS[target]), batch=batch, seed=seed,
        backend=backend, opt_level=opt_level, dtype=dtype,
        calib=x_np if dtype == "int8" else None, device=device)
    _sync(acc.device)
    t_build = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(acc.device)
            if acc.device.type == "cuda" else "cpu")
    calib = (f" (calibration {acc.calib_ms:.0f}ms)"
             if acc.calib_ms is not None else "")
    print(f"build (DSE+compile+validate+weights): {t_build * 1e3:.0f}ms"
          f"{calib}; {acc.n_instructions} instructions; arch: {arch}; "
          f"dtype: {dtype}; PE backend: {backend}; opt_level: {opt_level}; "
          f"device: {acc.device} ({name})")

    x = torch.from_numpy(x_np).to(acc.device)
    t0 = time.perf_counter()
    y = acc(x)
    _sync(acc.device)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        y = acc(x)
    _sync(acc.device)
    t_steady = (time.perf_counter() - t0) / iters
    print(f"first request: {t_first * 1e3:.1f}ms; steady: "
          f"{t_steady * 1e3:.2f}ms/batch{batch} "
          f"({batch / t_steady:.1f} images/s) over {iters} requests")
    return y.cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", dest="arch", default="vgg16",
                    choices=sorted(SIZES))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20,
                    help="steady-state requests to time")
    ap.add_argument("--target", default="tpu", choices=sorted(CNN_TARGETS),
                    help="DSE planning model (the reference's TPU v5e or "
                         "FPGA targets)")
    ap.add_argument("--backend", default="torch", choices=("torch", "hopper"),
                    help="PE implementation: aten ops or the hand-written "
                         "CUDA kernels")
    ap.add_argument("--opt-level", type=int, default=1, choices=(0, 1))
    ap.add_argument("--dtype", default="float32", choices=("float32", "int8"),
                    help="int8 calibrates on the request batch and serves "
                         "the quantized accelerator (K5 on hopper)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    y = serve_cnn(args.arch, reduced=args.reduced, batch=args.batch,
                  iters=args.iters, target=args.target, backend=args.backend,
                  opt_level=args.opt_level, dtype=args.dtype,
                  device=args.device)
    print("logits:", y.shape)


if __name__ == "__main__":
    main()
