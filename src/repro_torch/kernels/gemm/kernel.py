"""K2 ``bmm_f32``: batched fp32 GEMM with an optional bias/ReLU epilogue.

Replaces ``src/repro/kernels/gemm/kernel.py::batched_matmul_kernel``:
``(G, M, K) @ (G, K, N)`` with fp32 accumulation and an optional ``(G, N)``
bias plus ReLU. On the main path it is the PT^2-batched Winograd GEMM
(G = 36) and, with G = 1, every FC layer. The CUDA kernel
(``csrc/gemm_f32.cu``, shared with K1) runs 3xTF32 on the tensor cores
(``wgmma``) where M >= 64, K and N are multiples of 4 and the operands
16-byte aligned (the Winograd GEMMs), and the fp32 FMA pipes else (the
M = 8 FC layers); ``common.last_route`` names the route of the last launch.
It masks ragged edges itself, so nothing is padded; its note says what
bounds it and what the design does about that.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import (
    counted,
    gemm_workspace,
    launch_gemm,
    on_cpu,
    traced,
)


def bmm_ref(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
            relu: bool = False, dataflow: str = "is") -> torch.Tensor:
    """Plain PyTorch version of :func:`bmm_f32` (same signature)."""
    y = torch.bmm(a, b)
    if bias is not None:
        y = y + bias[:, None, :]
    if relu:
        y = torch.relu(y)
    return y


def bmm_work(g: int, m: int, k: int, n: int,
             has_bias: bool = False) -> tuple[float, float]:
    """(FLOPs, bytes) of one (G, M, K) @ (G, K, N) call: a multiply-add
    per product; A, B and the bias read once, C written once."""
    return (2.0 * g * m * k * n,
            4.0 * (g * m * k + g * k * n + g * m * n
                   + (g * n if has_bias else 0)))


def _launch(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None,
            relu: bool, ws: bool) -> torch.Tensor:
    g, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((g, m, n), dtype=torch.float32, device=a.device)
    if out.numel():
        launch_gemm("bmm_f32", [a, b, bias, out,
                                gemm_workspace(g, m, k, n, a.device)],
                    [g, m, k, n, relu, ws], (g, m, k, n, a.device.index))
    return out


def bmm_f32(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
            relu: bool = False, dataflow: str = "is") -> torch.Tensor:
    """(G, M, K) @ (G, K, N) [+ bias (G, N)] [ReLU] -> (G, M, N), fp32.

    ``dataflow`` ("is"/"ws") picks the kernel's output-tile raster order and
    changes no numbers.
    """
    if dataflow not in ("is", "ws"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"bmm_f32 takes 3-D operands, got {a.shape}, {b.shape}")
    g, m, k = a.shape
    if b.shape[:2] != (g, k):
        raise ValueError(f"bmm_f32 shape mismatch: {a.shape} @ {b.shape}")
    n = b.shape[2]
    if bias is not None and bias.shape != (g, n):
        raise ValueError(f"bmm_f32 bias must be {(g, n)}, got {bias.shape}")
    if traced(a):
        return torch.ops.repro_torch.bmm_f32(a, b, bias, relu,
                                             dataflow == "ws")
    cpu = on_cpu("bmm_f32", a, b, bias)
    with counted("bmm_f32", bmm_work, g, m, k, n, bias is not None,
                 on=a.device):
        if cpu:
            return bmm_ref(a, b, bias, relu, dataflow)
        return _launch(a, b, bias, relu, dataflow == "ws")


# the exportable op: CPU runs the plain version, CUDA the same launch
@torch.library.custom_op("repro_torch::bmm_f32", mutates_args=(),
                         device_types="cpu")
def _bmm_op(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
            relu: bool, ws: bool) -> torch.Tensor:
    return bmm_ref(a, b, bias, relu)


@_bmm_op.register_kernel("cuda")
def _(a, b, bias, relu, ws):
    on_cpu("bmm_f32", a, b, bias)
    return _launch(a, b, bias, relu, ws)


@_bmm_op.register_fake
def _(a, b, bias, relu, ws):
    return a.new_empty((a.shape[0], a.shape[1], b.shape[2]))
