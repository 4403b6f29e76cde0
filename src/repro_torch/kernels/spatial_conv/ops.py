"""Spatial convolution on the Spatial-mode PE kernel (K1).

The LOAD manager's Spatial-mode addressing (Sec. 4.2.3) maps each output
pixel to its patch of the NHWC input. The patch features are ordered
``(R, S, C)`` — channel innermost, so a patch row reads contiguous channels —
which is exactly the HWIO weight reshaped to ``(R*S*C, K)`` with no
transpose. (The reference orders its patches ``(C, R, S)`` and transposes
its weights to match; the conv output is the same.)

Where :func:`~repro_torch.kernels.spatial_conv.kernel.takes_implicit` holds
(channels in fours, the patch GEMM on the tensor cores, the map's chunks
aligned) K1 does that addressing itself on the map as given, views
included, with every pad as geometry (``conv_implicit_f32``). Elsewhere
(the first CONV's 3 channels, fewer than 64 output pixels) ``im2col`` copies
the padded input into the ``(T, R*S*C)`` patch matrix, as the reference
builds its patch matrix outside the kernel, and K1 multiplies that
(``conv_gemm_f32``). Ragged shapes need no padding: the kernel masks its
edges.

``padding`` accepts "SAME"/"VALID" or an explicit ``((top, bottom),
(left, right))`` pair — the executor's blocked lowering slices the vertical
halo itself and passes explicit horizontal pads. Strided SAME uses the
stride-aware ``same_pad``.
"""
from __future__ import annotations

import torch

from repro_torch.core.hybrid_conv import explicit_pads
from repro_torch.kernels.spatial_conv.kernel import (
    conv_gemm_f32,
    conv_implicit_f32,
    im2col,
    takes_implicit,
)


def spatial_conv2d(x_nhwc: torch.Tensor, g_rsck: torch.Tensor,
                   bias: torch.Tensor | None = None, *, stride: int = 1,
                   padding="SAME", relu: bool = False,
                   dataflow: str = "is") -> torch.Tensor:
    """NHWC x HWIO -> NHWC, fp32, through K1."""
    n, h, w, c = x_nhwc.shape
    r, s, _, k = g_rsck.shape
    pads = explicit_pads(padding, h, w, r, s, stride)
    g = g_rsck.contiguous()
    b = None if bias is None else bias.contiguous()
    if takes_implicit(x_nhwc, g, stride, pads):
        return conv_implicit_f32(x_nhwc, g, b, stride=stride, pads=pads,
                                 relu=relu, dataflow=dataflow)
    patches, (ho, wo) = im2col(x_nhwc, r, s, stride, pads)
    y = conv_gemm_f32(patches, g.reshape(r * s * c, k), b, relu=relu,
                      dataflow=dataflow)
    return y.reshape(n, ho, wo, k)
