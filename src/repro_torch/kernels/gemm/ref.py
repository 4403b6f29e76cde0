"""Float64 oracle for the batched GEMM (independent of the kernel's plain
version, which runs in fp32)."""
from __future__ import annotations

import torch


def batched_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, M, K) @ (G, K, N) -> (G, M, N), accumulated in float64."""
    return torch.einsum("gmk,gkn->gmn", a.double(), b.double()).float()


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batched_matmul_ref(a[None], b[None])[0]
