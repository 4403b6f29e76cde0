"""Serving entry points of the PyTorch port, on a CUDA card by default.

LM serving (batched prefill, then greedy decode with a KV cache; the dense
family, e.g. full-width minitron-8b on one H100):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b \
      --no-reduced --batch 2 --prompt-len 4096 --gen 16 --backend hopper

Prompts of 2048 tokens and more take the long-sequence attention: K6 with
``--backend hopper``, the scan-flash port with ``--backend torch``. Prints
the build (random weights from seed 0), prefill and per-token decode
times.

CNN serving through the ported HybridDNN pipeline — DSE -> compile ->
validated, cached executor:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vgg16 \
      --no-reduced --batch 8 --backend hopper [--dtype int8]

``--arch resnet18`` serves ResNet-18 (``--no-reduced``: the full-width
``resnet18_specs(128, 1, n_classes=1000)``). ``--dtype int8`` calibrates on
the request batch, as the reference does, and serves the int8 accelerator.
``--device cpu`` runs the same flow on the CPU (``hopper`` then runs each
kernel's plain version). Prints the DSE verdict (``Accelerator.summary``),
the build time (and, for int8, the calibration time inside it), the first
request's time and the steady-state ms/batch and images/s. ``--session``
also drives ``batch * iters`` single-image requests through a
``ServingSession`` on one device (``--scheduler``, ``--deadline-ms``,
``--queue-limit``; the reference's ``--mesh`` waits for sharded serving)
and prints its throughput, latency percentiles and failure-model
counters; ``--segmented`` (VGG16, fp32) builds the legacy multi-Program
path instead. ``--compare-interpreter`` then times one request
through the strict per-instruction interpreter (``strict_request``: the
``torch`` PE, the same params and sidecar) against the steady executor and
prints the slowdown and ``max |diff|`` of the logits (int8: ``0.00e+00``,
compared after dequantization).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.compat import resolve_backend, resolve_device
from repro_torch.configs.base import get_config, list_archs

CNN_TARGETS = {"tpu": "V5E", "vu9p": "VU9P", "pynq": "PYNQ_Z1"}
# (img, scale) per arch: reduced, then full width (ResNet-18 at 128: the
# largest power-of-two resolution whose flattened FC input fits the ISA)
SIZES = {"vgg16": ((64, 8), (224, 1)), "resnet18": ((64, 8), (128, 1))}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class LMServeResult:
    """What :func:`serve` returns: the generated tokens (B, gen), the
    prefill's last-token logits (B, V) on the device, and the timings."""
    tokens: np.ndarray
    prefill_logits: torch.Tensor
    build_ms: float | None      # None when the caller passed ``params``
    prefill_ms: float
    decode_ms_per_token: float


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, seed: int = 0,
          backend: str = "torch", device=None, params=None) -> LMServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (numpy
    ``default_rng(seed)``, as the reference), then decode ``gen`` tokens
    greedily. Weights are drawn from ``seed`` unless ``params`` (the tree
    of ``train.steps.init_params``) is given. Prints and returns the
    timings."""
    from repro_torch.train import steps as steps_lib

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.family == "cnn":
        raise ValueError(f"{arch} is a CNN: serve it with serve_cnn")
    backend = resolve_backend(backend)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    build_ms = None
    if params is None:
        t0 = time.perf_counter()
        params = steps_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        _sync(dev)
        build_ms = (time.perf_counter() - t0) * 1e3
    prefill_fn, decode_fn = steps_lib.make_serve_steps(cfg, backend=backend)
    cache = steps_lib.init_cache(cfg, batch, prompt_len + gen, dev)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                           dtype=np.int32)

    tokens = torch.from_numpy(prompts).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, tokens, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    prefill_logits = logits
    outs = []
    tok = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for i in range(gen):
        outs.append(tok[:, 0])
        logits, cache = decode_fn(params, tok, cache, prompt_len + i)
        tok = logits.argmax(-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen_tokens = (torch.stack(outs, 1).cpu().numpy() if outs
                  else np.zeros((batch, 0), np.int64))
    per_token = t_decode / gen * 1e3 if gen else 0.0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    built = f"build {build_ms:.0f}ms; " if build_ms is not None else ""
    print(f"{cfg.name} ({'reduced' if reduced else 'full'}, {cfg.dtype}) "
          f"on {dev} ({name}), backend {backend}: {built}prefill "
          f"{prompt_len} toks x{batch}: {t_prefill * 1e3:.1f}ms; decode "
          f"{gen} steps: {per_token:.2f}ms/tok")
    return LMServeResult(tokens=gen_tokens, prefill_logits=prefill_logits,
                         build_ms=build_ms, prefill_ms=t_prefill * 1e3,
                         decode_ms_per_token=per_token)


def serve_cnn(arch: str = "vgg16", *, reduced: bool = True, batch: int = 8,
              iters: int = 20, seed: int = 0, target: str = "tpu",
              backend: str = "torch", opt_level: int = 1,
              dtype: str = "float32", device=None,
              compare_interpreter: bool = False, segmented: bool = False,
              session: bool = False,
              scheduler: str = "continuous",
              deadline_ms: float | None = None,
              queue_limit: int | None = None) -> np.ndarray:
    """Build the accelerator, answer one first request and ``iters`` steady
    requests, print the timings and return the last logits.
    ``compare_interpreter`` also times one interpreted request against the
    steady executor (after one warm-up) and prints ``max |diff|``.
    ``segmented`` builds the legacy multi-Program path (VGG16 only);
    ``session`` also serves ``batch * iters`` single images through a
    :class:`~repro_torch.api.ServingSession` on one device (``scheduler``,
    ``deadline_ms``, ``queue_limit``) and prints its statistics."""
    from repro_torch import api
    from repro_torch.core import perf_model as pm
    from repro_torch.models import resnet, vgg

    if arch not in SIZES:
        raise ValueError(f"CNN serving supports 'vgg16' (the paper's case "
                         f"study) and 'resnet18' (the residual workload), "
                         f"got {arch!r}")
    if target not in CNN_TARGETS:
        raise ValueError(f"--target must be one of {sorted(CNN_TARGETS)}")
    if segmented and arch == "resnet18":
        raise ValueError(
            "--segmented is the legacy conv-segment path (host-side maxpool "
            "glue between linear CONV runs) — a residual topology has no "
            "such segmentation; resnet18 serves single-Program only")
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
        segmented=segmented, backend=backend, opt_level=opt_level,
        dtype=dtype, calib=x_np if dtype == "int8" else None, device=device)
    _sync(acc.device)
    t_build = time.perf_counter() - t0
    print(acc.summary())
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
    if session:
        _serve_session(acc, x_np, iters, scheduler=scheduler,
                       deadline_ms=deadline_ms, queue_limit=queue_limit)
    if compare_interpreter:
        strict_request = acc.strict_request()
        strict_request(x)
        _sync(acc.device)
        t0 = time.perf_counter()
        y_i = strict_request(x)
        _sync(acc.device)
        t_interp = time.perf_counter() - t0
        if acc.quant is not None:       # both paths emit int8: compare in
            y_i = acc.quant.dequantize_output(y_i)   # the dequantized space
        err = float((y - y_i).abs().max())
        print(f"interpreter: {t_interp * 1e3:.1f}ms/batch "
              f"({t_interp / t_steady:.1f}x slower than cached executor; "
              f"max |diff| {err:.2e}; max |logit| "
              f"{float(y_i.abs().max()):.2e})")
    return y.cpu().numpy()


def _serve_session(acc, x_np: np.ndarray, iters: int, *, scheduler: str, deadline_ms: float | None,
                   queue_limit: int | None):
    """``len(x_np) * iters`` single images through a ServingSession with
    one bucket of the accelerator's batch; prints its statistics."""
    batch = x_np.shape[0]
    with acc.serve(max_batch=batch, buckets=(batch,), warmup=True,
                   scheduler=scheduler, deadline_ms=deadline_ms,
                   queue_limit=queue_limit) as s:
        n_req = batch * iters
        # requests materialized host-side before timing, like clients
        # arriving with their own arrays
        reqs = [x_np[i % batch] for i in range(n_req)]
        t0 = time.perf_counter()
        s.run_many(reqs)
        dt = time.perf_counter() - t0
        st = s.stats
        print(f"ServingSession[{scheduler}]: {n_req} requests "
              f"in {dt * 1e3:.1f}ms ({n_req / dt:.1f} req/s, {st.batches} "
              f"device batches, {st.padded_rows} padded rows, occupancy "
              f"{st.occupancy():.3f}; latency p50 {st.p50_ms():.2f}ms "
              f"p95 {st.p95_ms():.2f}ms; queue wait p50 "
              f"{st.wait_p50_ms():.2f}ms p95 {st.wait_p95_ms():.2f}ms; "
              f"compile {st.compile_ms:.0f}ms)")
        per_dev = ", ".join(f"{d}: {n}" for d, n in
                            sorted(st.device_batches.items()))
        print(f"  per-device batches: {{{per_dev}}}")
        # the liveness ledger: submitted == completed + errors + shed
        print(f"  failure model: submitted {st.submitted} = completed "
              f"{st.requests} + errors {st.errors} + shed {st.shed}; "
              f"deadline_exceeded {st.deadline_exceeded}, retries "
              f"{st.retries}, isolated {st.isolated}, degraded "
              f"{st.degraded}, watchdog restarts {st.watchdog_restarts}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", dest="arch", required=True,
                    choices=sorted(set(SIZES) | set(list_archs())),
                    help="a CNN (vgg16, resnet18) or an LM of the registry")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM prompt tokens")
    ap.add_argument("--gen", type=int, default=16,
                    help="LM tokens to decode greedily")
    ap.add_argument("--iters", type=int, default=20,
                    help="steady-state requests to time")
    ap.add_argument("--target", default="tpu", choices=sorted(CNN_TARGETS),
                    help="DSE planning model (the reference's TPU v5e or "
                         "FPGA targets)")
    ap.add_argument("--backend", default="torch", choices=("torch", "hopper"),
                    help="PE / long-sequence attention implementation: aten "
                         "ops or the hand-written CUDA kernels")
    ap.add_argument("--opt-level", type=int, default=1, choices=(0, 1))
    ap.add_argument("--dtype", default="float32", choices=("float32", "int8"),
                    help="int8 calibrates on the request batch and serves "
                         "the quantized accelerator (K5 on hopper)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--compare-interpreter", action="store_true",
                    help="also time one request through the strict "
                         "per-instruction interpreter and print max |diff|")
    ap.add_argument("--segmented", action="store_true",
                    help="legacy multi-Program CNN path (one Program per "
                         "CONV segment, host-side maxpool/FC glue)")
    ap.add_argument("--session", action="store_true",
                    help="also drive single-image requests through the "
                         "batching ServingSession")
    ap.add_argument("--scheduler", default="continuous",
                    choices=("continuous", "bucketed"),
                    help="ServingSession admission policy: 'continuous' "
                         "keeps admitting while the device pipeline is "
                         "busy; 'bucketed' is the legacy fixed window")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for the ServingSession")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the ServingSession's pending queue; "
                         "overflow requests are shed with Overloaded")
    args = ap.parse_args()
    if args.arch not in SIZES:
        out = serve(args.arch, reduced=args.reduced, batch=args.batch,
                    prompt_len=args.prompt_len, gen=args.gen,
                    backend=args.backend, device=args.device)
        print("tokens:", out.tokens.shape)
        return
    y = serve_cnn(args.arch, reduced=args.reduced, batch=args.batch,
                  iters=args.iters, target=args.target, backend=args.backend,
                  opt_level=args.opt_level, dtype=args.dtype,
                  device=args.device,
                  compare_interpreter=args.compare_interpreter,
                  segmented=args.segmented, session=args.session,
                  scheduler=args.scheduler,
                  deadline_ms=args.deadline_ms,
                  queue_limit=args.queue_limit)
    print("logits:", y.shape)


if __name__ == "__main__":
    main()
