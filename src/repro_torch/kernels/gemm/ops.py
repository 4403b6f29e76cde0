"""Public wrappers around the batched GEMM kernel.

The reference pads every operand to block multiples before its Pallas call;
the CUDA kernel masks its ragged edges itself, so these wrappers only make
the operands contiguous.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm.kernel import bmm_f32


def batched_matmul(a: torch.Tensor, b: torch.Tensor, *,
                   bias: torch.Tensor | None = None, relu: bool = False,
                   dataflow: str = "is") -> torch.Tensor:
    """(G, M, K) @ (G, K, N) -> (G, M, N), fp32 accumulation."""
    return bmm_f32(a.contiguous(), b.contiguous(),
                   None if bias is None else bias.contiguous(),
                   relu=relu, dataflow=dataflow)


def matmul(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """2-D convenience wrapper: (M, K) @ (K, N)."""
    return batched_matmul(a[None], b[None], **kw)[0]
