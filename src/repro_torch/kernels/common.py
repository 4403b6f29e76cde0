"""Shared helpers for the hand-written Hopper kernels.

The CUDA C++ sources under ``repro_torch/csrc/`` build at first use into one
shared library with a plain ``extern "C"`` interface, loaded with ``ctypes``:
``nvcc`` compiles every source in parallel for ``sm_90a`` and links them
into ``build/repro_torch/libhybriddnn_hopper_<digest>.so`` at the root of
the checkout. The digest covers the sources and the flags, so a stale
library is never loaded. A missing or failing ``nvcc`` raises with its
stderr; nothing falls back.

Each kernel wrapper dispatches on the device of its tensors only: a CPU
tensor runs the kernel's plain PyTorch version (the analog of Pallas
interpret mode), a CUDA tensor launches the kernel or raises. No kernel
has a backward: on either device a wrapper raises when grad mode is on and
an operand requires grad, rather than return an output with no
``grad_fn``. ``LAUNCHES``
counts the launches of each kernel; :func:`launch` adds one per launch,
:func:`add_launches` adds a CUDA graph's recorded launches at each replay,
and nothing else touches the counts except :func:`reset_launches`.

Under a roofline counter (``launch/roofline.py``), each wrapper declares
its kernel's work once per call, from the one formula beside it (the
``*_work`` functions, which ``chip_smoke.py``'s bounds read too), and runs
its launch or its plain version uncounted (:func:`counted`): the
``hopper`` backend counts the same on the CPU as on the card.

The CNN kernels' entries are also ``torch.library`` ops in the
``repro_torch`` namespace (``torch.ops.repro_torch.<name>``), each with a fake
implementation, so ``torch.export`` can trace an executor through them
(``core/aot.py``): their CUDA implementation is the same launch, their CPU
one the plain version. A wrapper takes the op only while it is traced
(:func:`traced`); eager calls and CUDA-graph captures go straight to the
launch, which skips the dispatcher's host time.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from repro_torch.launch import roofline

KERNELS = ("conv_gemm_f32", "conv_implicit_f32", "bmm_f32",
           "wino_input_transform_f32", "wino_output_transform_f32", "qmm_i8",
           "flash_attention")

# launches per kernel since the last reset_launches()
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

# the routes of the fp32 GEMM body (csrc/gemm_f32.cu), by gemm_f32_route's
# code, of the int8 GEMM (csrc/gemm_i8.cu), by qmm_i8_route's, and of the
# Winograd transforms (csrc/winograd_f32.cu), by wino_f32_route's
GEMM_ROUTES = ("fma", "fma_splitk", "tc3xtf32")
QMM_ROUTES = ("dp4a", "dp4a_bytes", "tc_s8")
WINO_ROUTES = ("scalar", "vec4")
# each entry with several routes: the library function that names its route
# and the names of its codes
_ROUTES = {
    "conv_gemm_f32": ("gemm_f32_route", GEMM_ROUTES),
    "conv_implicit_f32": ("gemm_f32_route", GEMM_ROUTES),
    "bmm_f32": ("gemm_f32_route", GEMM_ROUTES),
    "qmm_i8": ("qmm_i8_route", QMM_ROUTES),
    "wino_input_transform_f32": ("wino_f32_route", WINO_ROUTES),
    "wino_output_transform_f32": ("wino_f32_route", WINO_ROUTES),
}
# the route function's arguments (operand addresses and sizes) for the last
# launch of each such entry, from which last_route() names the route
_LAST_ROUTE: dict[str, tuple] = {}

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int64
# (pointer args, int64 args); every entry then takes the device index and
# the stream, which launch() appends
_SIGNATURES = {
    # P, W, bias, Y, workspace; T, CRS, K, relu, ws
    "conv_gemm_f32": (5, 5),
    # x, W, bias, Y, workspace; x's N, H, W strides, N, H, W, C, K, R, S,
    # stride, pad top, pad left, HO, WO, relu, ws
    "conv_implicit_f32": (5, 17),
    # A, B, bias, C, workspace; G, M, K, N, relu, ws
    "bmm_f32": (5, 6),
    # x, V; N, H, W, C, pad top, pad left, nh, nw, m
    "wino_input_transform_f32": (2, 9),
    # M, bias, Y; N, Ho, Wo, K, nh, nw, m, relu
    "wino_output_transform_f32": (3, 8),
    # A, B, bias, mult, C, workspace; M, K, N, relu
    "qmm_i8": (6, 4),
    # Q, K, V, O; BH, group, Sq, Skv, D, kv_len, causal, bf16, scale bits,
    # row offset
    "flash_attention": (4, 10),
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
# each entry of _SIGNATURES, resolved from the library once
_entries: dict[str, ctypes._CFuncPtr] = {}
# nvcc's output (-Xptxas -v) from the build of the loaded library, kept
# beside it, so a later process that finds the library built reads it too
BUILD_LOG = ""


# while a thread captures a CUDA graph, its launches are recorded here
# (the kernels run at each replay, not at the capture), and the cached
# device constants the capture reads are kept here
_recording = threading.local()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launches(counts: dict[str, int]) -> None:
    """Count a replayed CUDA graph's launches (recorded at its capture)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches go into the yielded dict
    instead of ``LAUNCHES``: a CUDA graph's capture enqueues its kernels
    without running them."""
    counts = dict.fromkeys(KERNELS, 0)
    prev = getattr(_recording, "counts", None)
    _recording.counts = counts
    try:
        yield counts
    finally:
        _recording.counts = prev


@contextlib.contextmanager
def holding_constants():
    """Within the block, every cached device constant this thread reads
    through :func:`hold` goes into the yielded list: a CUDA graph reads
    them by address, so its capture keeps them for as long as the graph
    lives, whatever the cache they came from evicts meanwhile."""
    held: list[torch.Tensor] = []
    prev = getattr(_recording, "held", None)
    _recording.held = held
    try:
        yield held
    finally:
        _recording.held = prev


def hold(t: torch.Tensor) -> torch.Tensor:
    """``t``, a cached device constant, kept by the capture in progress on
    this thread, if any (see :func:`holding_constants`)."""
    held = getattr(_recording, "held", None)
    if held is not None:
        held.append(t)
    return t


def counted(name: str, work, *args, on=None, **kwargs):
    """A context for one call of kernel ``name`` on device ``on`` (its
    launch or its plain version): under an active roofline counter it
    declares ``work(*args, **kwargs)`` (FLOPs, bytes) once and counts no
    aten op inside; else it does nothing."""
    if not roofline.counting():
        return contextlib.nullcontext()
    roofline.declare_work(name, *work(*args, **kwargs), device=on)
    return roofline.uncounted()


def traced(t: torch.Tensor) -> bool:
    """True when ``t`` is not a plain tensor: ``torch.export`` is tracing
    the wrapper with fake tensors, so it must emit the kernel's
    ``torch.ops.repro_torch`` op instead of launching."""
    return type(t) is not torch.Tensor


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the Hopper kernels build from "
            f"{CSRC_DIR} at first use and need the CUDA toolkit")
    return nvcc


def build_library() -> Path:
    """Compile the CUDA sources (one ``nvcc`` per source, all in parallel)
    and link them into the digest-keyed shared library; return its path."""
    global BUILD_LOG
    lib_path = BUILD_DIR / f"libhybriddnn_hopper_{source_digest()}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        if log_path.exists():
            BUILD_LOG = log_path.read_text()
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = Path(tmp) / f"{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, _, proc in jobs:
            out, err = proc.communicate()
            log.append(f"== {src.name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} "
                              f"(exit {proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *[str(obj) for _, obj, _ in jobs], "-o", str(tmp_lib)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        BUILD_LOG = "".join(log)
        tmp_log = Path(tmp) / log_path.name
        tmp_log.write_text(BUILD_LOG)
        os.replace(tmp_log, log_path)
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds agree
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (n_ptr, n_int) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_P] * n_ptr + [_I] * (n_int + 1) + [_P]
                fn.restype = ctypes.c_int
            lib.gemm_f32_workspace.argtypes = [_I] * 5
            lib.gemm_f32_workspace.restype = _I
            lib.gemm_f32_route.argtypes = [_P] * 4 + [_I] * 5
            lib.gemm_f32_route.restype = ctypes.c_int
            lib.qmm_i8_workspace.argtypes = [_I] * 4
            lib.qmm_i8_workspace.restype = _I
            lib.qmm_i8_route.argtypes = [_P] * 4 + [_I] * 3
            lib.qmm_i8_route.restype = ctypes.c_int
            lib.wino_f32_route.argtypes = [_P] * 3 + [_I]
            lib.wino_f32_route.restype = ctypes.c_int
            lib.hybriddnn_error_string.argtypes = [ctypes.c_int]
            lib.hybriddnn_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def on_cpu(name: str, *tensors: torch.Tensor | None,
           dtypes: torch.dtype | tuple = torch.float32,
           strided: int = 0) -> bool:
    """Check a kernel's operands; True when they lie on the CPU (run the
    plain version), False on CUDA (launch the kernel). ``dtypes`` is the
    type every operand must have, or one type per operand. Anything the
    kernel does not take raises: an operand that requires grad while grad
    mode is on (no kernel has a backward), mixed devices, another device
    type, a wrong dtype, or a non-contiguous tensor, except among the first
    ``strided`` operands, which the kernel reads through their strides
    (the caller checks those)."""
    if not isinstance(dtypes, tuple):
        dtypes = (dtypes,) * len(tensors)
    if len(dtypes) != len(tensors):
        raise ValueError(f"{name}: {len(tensors)} operands, "
                         f"{len(dtypes)} dtypes")
    present = [(t, d, i < strided)
               for i, (t, d) in enumerate(zip(tensors, dtypes))
               if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t, _, _ in present):
        raise RuntimeError(
            f"{name}: the kernel has no backward (neither has the "
            f"reference's), so its output would drop the gradient; call it "
            f"under torch.no_grad() or on inputs that do not require grad")
    devices = {t.device for t, _, _ in present}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    for t, dtype, is_strided in present:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {str(dtype)[6:]}, got "
                            f"{t.dtype}")
        if not is_strided and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return False


@functools.lru_cache(maxsize=1024)
def _gemm_workspace_floats(g: int, m: int, k: int, n: int, index: int) -> int:
    return library().gemm_f32_workspace(g, m, k, n, index)


def gemm_workspace(g: int, m: int, k: int, n: int,
                   device: torch.device) -> torch.Tensor | None:
    """The split-K scratch the GEMM kernel needs for a (G, M, K, N) product
    on ``device``, or None when it does not split K."""
    size = _gemm_workspace_floats(g, m, k, n, device.index)
    if size == 0:
        return None
    return torch.empty(size, dtype=torch.float32, device=device)


def launch_gemm(name: str, tensors: list[torch.Tensor | None],
                sizes: list[int], route_sizes: tuple[int, ...]) -> None:
    """Launch a GEMM entry (``conv_gemm_f32``, ``bmm_f32``: A, B, bias, out,
    workspace; ``conv_implicit_f32``: the map as A; ``qmm_i8``: A, B, bias,
    mult, out, workspace) and keep what
    decides its route for :func:`last_route`: the operands' addresses and
    ``route_sizes``, the sizes its route function takes after them."""
    a, b, out, ws = tensors[0], tensors[1], tensors[-2], tensors[-1]
    launch(name, tensors, sizes,
           route_args=(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                       None if ws is None else ws.data_ptr(), *route_sizes))


def last_route(name: str) -> str | None:
    """The route of the last launch of entry ``name``, as the kernel
    library decides it: ``GEMM_ROUTES`` for ``conv_gemm_f32``,
    ``conv_implicit_f32`` and ``bmm_f32``, ``QMM_ROUTES`` for ``qmm_i8``, ``WINO_ROUTES`` for the
    Winograd transforms; None before the first launch."""
    if name not in _LAST_ROUTE:
        return None
    fn, names = _ROUTES[name]
    return names[getattr(library(), fn)(*_LAST_ROUTE[name])]


@functools.lru_cache(maxsize=1024)
def _qmm_workspace_words(m: int, k: int, n: int, index: int) -> int:
    return library().qmm_i8_workspace(m, k, n, index)


def qmm_workspace(m: int, k: int, n: int,
                  device: torch.device) -> torch.Tensor | None:
    """The int32 scratch the int8 GEMM kernel needs for an (M, K, N)
    product on ``device`` (split-K partials, and the transposed B of the
    tensor-core route), or None when it needs none."""
    size = _qmm_workspace_words(m, k, n, device.index)
    if size == 0:
        return None
    return torch.empty(size, dtype=torch.int32, device=device)


def _entry(name: str) -> ctypes._CFuncPtr:
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(), name)
    return fn


def launch(name: str, tensors: list[torch.Tensor | None], sizes: list[int],
           route_args: tuple | None = None) -> None:
    """Launch kernel ``name`` on the current stream of its tensors' device;
    raise if the launch is refused. Counts one launch. The entry itself
    makes that device current for the launch and gives the caller's back
    (``DeviceScope`` in ``csrc/hopper_common.cuh``). ``route_args``, for an
    entry with several routes, are its route function's arguments, kept
    for :func:`last_route`."""
    fn = _entry(name)
    index = next(t.device for t in tensors if t is not None).index
    # the raw handle of the device's current stream, without the Stream
    # object torch.cuda.current_stream builds on every call
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = fn(*[None if t is None else t.data_ptr() for t in tensors],
             *[int(s) for s in sizes], index, stream)
    if err != 0:
        msg = library().hybriddnn_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({err}: {msg})")
    if route_args is not None:
        _LAST_ROUTE[name] = route_args
    counts = getattr(_recording, "counts", None)
    (LAUNCHES if counts is None else counts)[name] += 1
