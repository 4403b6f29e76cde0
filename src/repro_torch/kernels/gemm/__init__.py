"""The shared PE: a batched fp32 GEMM (K2), hand-written for Hopper.

The leading batch axis ranges over the PT^2 independent GEMMs of the
Winograd formulation (Eq. 2); the FC layers use the same kernel with a
singleton leading axis.
"""
from repro_torch.kernels.gemm.ops import batched_matmul, matmul

__all__ = ["batched_matmul", "matmul"]
