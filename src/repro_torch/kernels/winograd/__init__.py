"""Hopper kernels for the Winograd input/output transforms (K3, K4).

The paper's load manager performs the online ``B^T d B`` input transform and
the save manager the ``A^T M A`` output transform (Sec. 4.2.3); the
EWMM-as-GEMM middle stage is the shared batched GEMM (K2) with batch PT^2.
"""
from repro_torch.kernels.winograd.ops import (
    input_transform,
    output_transform,
    winograd_apply_pretransformed_hopper,
    winograd_conv2d,
)

__all__ = ["input_transform", "output_transform",
           "winograd_apply_pretransformed_hopper", "winograd_conv2d"]
