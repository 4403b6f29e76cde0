"""K1 ``conv_gemm_f32``: the Spatial-mode PE, an im2col patch GEMM.

Replaces ``src/repro/kernels/spatial_conv/kernel.py::conv_gemm_kernel``:
``(T, C*R*S) @ (C*R*S, K)`` with fp32 accumulation and the bias add plus
optional ReLU fused at the store. The CUDA kernel lives in
``csrc/gemm_f32.cu`` and shares its bodies with K2: 3xTF32 on the tensor
cores (``wgmma``) where M >= 64, CRS and K are multiples of 4 and the
operands 16-byte aligned, the fp32 FMA pipes else (K = 27 of the first
CONV); ``common.last_route`` names the route of the last launch. Its note
says what bounds it and what the design does about that. The IS/WS dataflow
maps to the raster order of output tiles and changes no numbers.
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


def conv_gemm_ref(patches: torch.Tensor, weights: torch.Tensor,
                  bias: torch.Tensor | None = None, relu: bool = False,
                  dataflow: str = "is") -> torch.Tensor:
    """Plain PyTorch version of :func:`conv_gemm_f32` (same signature)."""
    y = patches @ weights
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def conv_gemm_work(t: int, crs: int, k: int,
                   has_bias: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of one (T, CRS) @ (CRS, K) call: a multiply-add per
    product; P, W and the bias read once, Y written once."""
    return (2.0 * t * crs * k,
            4.0 * (t * crs + crs * k + t * k + (k if has_bias else 0)))


def _launch(patches: torch.Tensor, weights: torch.Tensor,
            bias: torch.Tensor | None, relu: bool, ws: bool) -> torch.Tensor:
    t, crs = patches.shape
    k = weights.shape[1]
    out = torch.empty((t, k), dtype=torch.float32, device=patches.device)
    if out.numel():
        launch_gemm("conv_gemm_f32",
                    [patches, weights, bias, out,
                     gemm_workspace(1, t, crs, k, patches.device)],
                    [t, crs, k, relu, ws],
                    (1, t, crs, k, patches.device.index))
    return out


def conv_gemm_f32(patches: torch.Tensor, weights: torch.Tensor,
                  bias: torch.Tensor | None = None, relu: bool = False,
                  dataflow: str = "is") -> torch.Tensor:
    """(T, CRS) @ (CRS, K) [+ bias (K,)] [ReLU] -> (T, K), fp32."""
    if dataflow not in ("is", "ws"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if patches.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"conv_gemm_f32 takes 2-D operands, got "
                         f"{patches.shape}, {weights.shape}")
    crs = patches.shape[1]
    if weights.shape[0] != crs:
        raise ValueError(f"conv_gemm_f32 shape mismatch: {patches.shape} @ "
                         f"{weights.shape}")
    k = weights.shape[1]
    if bias is not None and bias.shape != (k,):
        raise ValueError(f"conv_gemm_f32 bias must be {(k,)}, got {bias.shape}")
    if traced(patches):
        return torch.ops.repro_torch.conv_gemm_f32(
            patches, weights, bias, relu, dataflow == "ws")
    cpu = on_cpu("conv_gemm_f32", patches, weights, bias)
    with counted("conv_gemm_f32", conv_gemm_work, patches.shape[0], crs, k,
                 bias is not None, on=patches.device):
        if cpu:
            return conv_gemm_ref(patches, weights, bias, relu, dataflow)
        return _launch(patches, weights, bias, relu, dataflow == "ws")


# the exportable op: CPU runs the plain version, CUDA the same launch
@torch.library.custom_op("repro_torch::conv_gemm_f32", mutates_args=(),
                         device_types="cpu")
def _conv_gemm_op(patches: torch.Tensor, weights: torch.Tensor,
                  bias: Optional[torch.Tensor], relu: bool,
                  ws: bool) -> torch.Tensor:
    return conv_gemm_ref(patches, weights, bias, relu)


@_conv_gemm_op.register_kernel("cuda")
def _(patches, weights, bias, relu, ws):
    on_cpu("conv_gemm_f32", patches, weights, bias)
    return _launch(patches, weights, bias, relu, ws)


@_conv_gemm_op.register_fake
def _(patches, weights, bias, relu, ws):
    return patches.new_empty((patches.shape[0], weights.shape[1]))
