"""Direct-convolution oracle for the Winograd path."""
from __future__ import annotations

import torch

from repro_torch.core.hybrid_conv import conv2d_torch


def conv2d_ref(x_nhwc: torch.Tensor, g_rsck: torch.Tensor, padding="SAME",
               bias: torch.Tensor | None = None, relu: bool = False,
               stride: int = 1) -> torch.Tensor:
    """Direct convolution (``F.conv2d``), fp32 — what Winograd must equal."""
    return conv2d_torch(x_nhwc, g_rsck, bias, stride=stride,
                        padding=padding, relu=relu)
