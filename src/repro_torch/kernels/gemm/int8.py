"""K5 ``qmm_i8``: int8 GEMM with exact int32 accumulation and the fused
requantize epilogue.

Replaces ``src/repro/kernels/gemm/int8.py::quantized_matmul`` (``_qmm``):
``A (M, K) int8 @ B (K, N) int8`` summed exactly in int32, then the int32
bias, an optional ReLU (valid before the rescale because the zero point is
0) and ``clip(round(acc * mult), -127, 127)`` back to int8, with one float32
multiplier per output channel. It is the int8 PE of every quantized CONV
(over im2col patches, ``quant/execute.py::qconv2d``) and FC layer
(``qdense``). The CUDA kernel (``csrc/gemm_i8.cu``) masks its ragged edges,
so nothing is padded; its note says what bounds it and what the design does
about that. Calls with M >= 64, K and N multiples of 16 and 16-byte aligned
operands take the int8 tensor cores (route ``tc_s8``); the rest the
``__dp4a`` body (``common.last_route("qmm_i8")`` names the route).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import (
    counted,
    launch_gemm,
    on_cpu,
    qmm_workspace,
    traced,
)

_DTYPES = (torch.int8, torch.int8, torch.int32, torch.float32)


def requantize_ref(acc: torch.Tensor, bias: torch.Tensor | None,
                   mult: torch.Tensor, relu: bool) -> torch.Tensor:
    """int32 accumulator -> int8: + bias, ReLU, one float32 multiply,
    round half to even, clip to +-127 (the kernel's epilogue)."""
    if bias is not None:
        acc = acc + bias
    if relu:
        acc = torch.clamp_min(acc, 0)
    y = torch.round(acc.to(torch.float32) * mult)
    return torch.clamp(y, -127, 127).to(torch.int8)


def qmm_ref(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
            mult: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`qmm_i8` (same signature).

    The product runs in float64, which is exact here on every device: each
    partial sum is an integer of magnitude at most ``K * 127**2`` (4.05e8 at
    the largest main-path K of 25088), far below 2**53. The rounding guards
    against a library that takes another route to the same sums.
    """
    return requantize_ref(exact_int_matmul(a, b), bias, mult, relu)


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> exact int32 sums, through float64."""
    return torch.round(a.double() @ b.double()).to(torch.int32)


def qmm_work(m: int, k: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one (M, K) @ (K, N) int8 call: a
    multiply-add per product; A, B (int8), the int32 bias and the float32
    multipliers read once, C (int8) written once."""
    return 2.0 * m * k * n, m * k + k * n + m * n + 8.0 * n


def qmm_i8(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
           mult: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 + bias (N,) int32, ReLU, requantize by
    mult (N,) float32 -> (M, N) int8."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"qmm_i8 takes 2-D operands, got {a.shape}, "
                         f"{b.shape}")
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"qmm_i8 shape mismatch: {a.shape} @ {b.shape}")
    n = b.shape[1]
    if bias.shape != (n,) or mult.shape != (n,):
        raise ValueError(f"qmm_i8 bias and mult must be {(n,)}, got "
                         f"{bias.shape} and {mult.shape}")
    if traced(a):
        return torch.ops.repro_torch.qmm_i8(a, b, bias, mult, relu)
    cpu = on_cpu("qmm_i8", a, b, bias, mult, dtypes=_DTYPES)
    with counted("qmm_i8", qmm_work, m, k, n, on=a.device):
        if cpu:
            return qmm_ref(a, b, bias, mult, relu)
        return _launch(a, b, bias, mult, relu)


def _launch(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
            mult: torch.Tensor, relu: bool) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int8, device=a.device)
    if out.numel():
        launch_gemm("qmm_i8", [a, b, bias, mult, out,
                               qmm_workspace(m, k, n, a.device)],
                    [m, k, n, relu], (m, k, n))
    return out


# the exportable op: CPU runs the plain version, CUDA the same launch
@torch.library.custom_op("repro_torch::qmm_i8", mutates_args=(),
                         device_types="cpu")
def _qmm_op(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
            mult: torch.Tensor, relu: bool) -> torch.Tensor:
    return qmm_ref(a, b, bias, mult, relu)


@_qmm_op.register_kernel("cuda")
def _(a, b, bias, mult, relu):
    on_cpu("qmm_i8", a, b, bias, mult, dtypes=_DTYPES)
    return _launch(a, b, bias, mult, relu)


@_qmm_op.register_fake
def _(a, b, bias, mult, relu):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.int8)


def multiplier_vector(mult, n: int, device) -> torch.Tensor:
    """A scalar or ``(N,)`` requantize multiplier -> a contiguous float32
    ``(N,)`` tensor on ``device`` (a scalar broadcasts, as in the
    reference). A tensor already on ``device`` costs no host copy."""
    if isinstance(mult, torch.Tensor):
        mult = mult.to(device=device, dtype=torch.float32)
    else:
        mult = torch.from_numpy(np.asarray(mult, np.float32)).to(device)
    if mult.dim() == 0 or mult.numel() == 1:
        return mult.reshape(()).expand(n).contiguous()
    if mult.shape != (n,):
        raise ValueError(f"mult must be a scalar or {(n,)}, got "
                         f"{tuple(mult.shape)}")
    return mult.contiguous()


def quantized_matmul(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor,
                     *, mult, relu: bool = False) -> torch.Tensor:
    """The reference's public signature: ``mult`` is
    ``in_scale * wgt_scale / out_scale``, a scalar (per-tensor weights) or
    ``(N,)`` (per-channel)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"quantized_matmul takes int8 operands, got "
                        f"{a.dtype}, {b.dtype}")
    n = b.shape[-1]
    return qmm_i8(a.contiguous(), b.contiguous(),
                  bias.to(torch.int32).contiguous(),
                  multiplier_vector(mult, n, a.device), relu=relu)
