"""Direct-convolution oracle for the spatial kernel."""
from __future__ import annotations

import torch

from repro_torch.core.hybrid_conv import conv2d_torch


def spatial_conv2d_ref(x_nhwc: torch.Tensor, g_rsck: torch.Tensor,
                       bias: torch.Tensor | None = None, *, stride: int = 1,
                       padding="SAME", relu: bool = False) -> torch.Tensor:
    """``F.conv2d`` on the same NHWC/HWIO operands, fp32."""
    return conv2d_torch(x_nhwc, g_rsck, bias, stride=stride,
                        padding=padding, relu=relu)
