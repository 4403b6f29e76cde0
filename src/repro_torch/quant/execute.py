"""The int8 PE dispatch, shared by both backends of the executor.

All ops take int8 tensors, accumulate exactly in int32 (integer sums are
exact in any order, so fused whole-layer and per-block lowerings of one
stream are bitwise identical), then requantize through a per-layer float32
multiplier; ReLU runs on the int32 accumulator before the rescale, which is
exact because the zero point is 0.

``backend="hopper"`` routes im2col patches (CONV) and activations (FC)
through K5, the hand-written int8 GEMM (``kernels/gemm/int8.py``), whose
epilogue fuses the same bias + ReLU + requantize. ``backend="torch"`` (the
reference's ``"xla"``) runs the product in float64 and casts it to int32:
exact on every device, because each partial sum is an integer of magnitude
at most ``K * 127**2``, far below 2**53, and aten has no integer conv on
CUDA while on the CPU an int8 conv or matmul returns int8 and wraps.
``qdepthwise`` takes that float64 route on both backends: depthwise is
element-parallel work, not a PE GEMM, and has no kernel.

Scales enter the arithmetic as float32 tensors on the operands' device (a
division or multiplication by a Python scalar may be rewritten by CUDA aten
as a multiplication by its reciprocal, and a host-to-device copy per call
would stall the request stream).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import resolve_backend, to_numpy
from repro_torch.core.hybrid_conv import (
    ConvSpec,
    DepthwiseSpec,
    FCSpec,
    explicit_pads,
)
from repro_torch.kernels.common import hold
from repro_torch.kernels.gemm.int8 import (
    exact_int_matmul,
    multiplier_vector,
    quantized_matmul,
    requantize_ref,
)
from repro_torch.kernels.spatial_conv.ops import im2col
from repro_torch.quant.sidecar import LayerQuant, QuantSidecar


def params_device(params) -> torch.device:
    """Where a ``[(w, b), ...]`` list lies: its first tensor's device, the
    CPU for numpy arrays."""
    for p in params:
        if isinstance(p[0], torch.Tensor):
            return p[0].device
    return torch.device("cpu")


def _f32_scalar(value: float, device) -> torch.Tensor:
    """A 0-dim float32 tensor on ``device``, filled there (no host copy)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def layer_multiplier(lq: LayerQuant, device: torch.device,
                     k_range: tuple[int, int] | None = None) -> torch.Tensor:
    """``lq.multiplier`` as a float32 tensor on ``device`` (0-dim for a
    per-tensor weight scale, ``(K,)`` per channel), sliced to the k-group
    ``k_range`` when per-channel. Built once per (layer, device, k-group),
    so steady requests make no host-to-device copy. The cache is bounded:
    a CUDA graph captured over the tensor keeps it (``common.hold``), so
    an eviction never frees memory a graph still reads."""
    return hold(_layer_multiplier(lq, device, k_range))


@functools.lru_cache(maxsize=1024)
def _layer_multiplier(lq: LayerQuant, device: torch.device,
                      k_range: tuple[int, int] | None) -> torch.Tensor:
    mult = lq.multiplier
    if np.ndim(mult) == 0:
        return _f32_scalar(mult, device)
    if k_range is not None:
        mult = mult[k_range[0]:k_range[1]]
    return torch.from_numpy(np.ascontiguousarray(mult, np.float32)).to(device)


def requantize(y_i32: torch.Tensor, mult, relu: bool) -> torch.Tensor:
    """int32 accumulator -> int8: optional ReLU, rescale, round half to
    even, clip — K5's epilogue. ``mult`` is a scalar or a ``(K,)`` vector
    over the trailing channel axis (a tensor, an array or a float)."""
    return requantize_ref(
        y_i32, None, multiplier_vector(mult, y_i32.shape[-1], y_i32.device),
        relu)


def quantize_tensor(x: torch.Tensor, scale: float) -> torch.Tensor:
    """fp -> int8 at a known scale (round half to even, symmetric clip)."""
    q = torch.round(x.to(torch.float32) / _f32_scalar(scale, x.device))
    return torch.clamp(q, -127, 127).to(torch.int8)


def qconv2d(x_i8: torch.Tensor, w_i8: torch.Tensor, b_i32: torch.Tensor, *,
            mult, stride: int = 1, padding="SAME", relu: bool = False,
            backend: str = "torch") -> torch.Tensor:
    """int8 spatial convolution, NHWC x HWIO -> NHWC int8 (Winograd is
    fp-only: the int8 DSE keeps Winograd plans off quantized builds)."""
    resolve_backend(backend)
    n, h, w, c = x_i8.shape
    r, s, _, k = w_i8.shape
    pads = explicit_pads(padding, h, w, r, s, stride)
    if backend == "hopper":
        # im2col over (R, S, C) patch features with the HWIO weight reshaped
        # to match; the reference orders them (C, R, S), and the integer sum
        # is the same bit for bit
        patches, (ho, wo) = im2col(x_i8, r, s, stride, pads)
        y = quantized_matmul(patches, w_i8.reshape(r * s * c, k), b_i32,
                             mult=mult, relu=relu)
        return y.reshape(n, ho, wo, k)
    acc = _exact_conv(x_i8, w_i8, stride, pads)
    return requantize(acc + b_i32.to(torch.int32), mult, relu)


def _exact_conv(x_i8: torch.Tensor, w_i8: torch.Tensor, stride: int, pads,
                groups: int = 1) -> torch.Tensor:
    """The exact int32 sums of an int8 NHWC x HWIO convolution (explicit
    ``pads``): the product in float64, rounded."""
    (pt, pb), (pl, pr) = pads
    xd = F.pad(x_i8.double(), (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    y = F.conv2d(xd, w_i8.double().permute(3, 2, 0, 1), stride=stride,
                 groups=groups)
    return torch.round(y).permute(0, 2, 3, 1).to(torch.int32)


def qdense(x_i8: torch.Tensor, w_i8: torch.Tensor, b_i32: torch.Tensor, *,
           mult, relu: bool = False, backend: str = "torch") -> torch.Tensor:
    """int8 FC through the shared GEMM PE (exact int32 accumulation)."""
    resolve_backend(backend)
    if backend == "hopper":
        return quantized_matmul(x_i8, w_i8, b_i32, mult=mult, relu=relu)
    return requantize(exact_int_matmul(x_i8, w_i8) + b_i32.to(torch.int32),
                      mult, relu)


def qeltwise(a_i8: torch.Tensor, b_i8: torch.Tensor, lq: LayerQuant,
             relu: bool) -> torch.Tensor:
    """Residual add across two int8 operands with different scales:
    dequantize both into the output scale's units, add, ReLU, round, clip.
    Each step rounds in float32 on its own, as the reference's does."""
    ma = _f32_scalar(float(lq.in_scale) / float(lq.out_scale), a_i8.device)
    mb = _f32_scalar(float(lq.skip_scale) / float(lq.out_scale), a_i8.device)
    y = a_i8.to(torch.float32) * ma + b_i8.to(torch.float32) * mb
    if relu:
        y = torch.clamp_min(y, 0.0)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def qdepthwise(x_i8: torch.Tensor, w_i8: torch.Tensor, b_i32: torch.Tensor,
               *, mult, stride: int = 1, padding="SAME",
               relu: bool = False) -> torch.Tensor:
    """int8 depthwise convolution, NHWC x ``(r, s, 1, C)`` -> NHWC int8:
    an exact grouped conv (float64, rounded to int32) + requantize. No
    kernel on either backend, as the fp32 depthwise."""
    _, h, w, c = x_i8.shape
    r, s = w_i8.shape[:2]
    acc = _exact_conv(x_i8, w_i8, stride,
                      explicit_pads(padding, h, w, r, s, stride), groups=c)
    return requantize(acc + b_i32.to(torch.int32), mult, relu)


def quantize_params(specs, params, sidecar: QuantSidecar,
                    device=None) -> list:
    """fp32 ``[(w, b), ...]`` -> int8 weights + int32 bias per the sidecar,
    computed in numpy exactly as the reference does, as tensors on
    ``device`` (default: where the first weight lies, else the CPU).

    The bias is stored at scale ``in_scale * wgt_scale`` — the int32
    accumulator's own units — so the epilogue adds it before the single
    rescale.
    """
    device = params_device(params) if device is None else device
    out, pi = [], 0
    for i, spec in enumerate(specs):
        if not isinstance(spec, (ConvSpec, FCSpec, DepthwiseSpec)):
            continue
        lq = sidecar.layers[i]
        w, b = params[pi]
        pi += 1
        # per-channel scales broadcast over the trailing (output-channel)
        # weight axis and elementwise over the bias
        ws = np.asarray(lq.wgt_scale, np.float32)
        w_i8 = np.clip(np.round(np.asarray(to_numpy(w), np.float32) / ws),
                       -127, 127).astype(np.int8)
        b_i32 = np.round(np.asarray(to_numpy(b), np.float32)
                         / (np.float32(lq.in_scale) * ws)).astype(np.int32)
        out.append((torch.from_numpy(w_i8).to(device),
                    torch.from_numpy(b_i32).to(device)))
    if pi != len(params):
        raise ValueError(
            f"params/specs mismatch: {len(params)} param entries for "
            f"{pi} parameterized layers")
    return out
