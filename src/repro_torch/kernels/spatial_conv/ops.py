"""Spatial convolution = im2col + the Spatial-mode PE kernel (K1).

im2col is the LOAD manager's Spatial-mode addressing (Sec. 4.2.3): one
strided view of the padded NHWC input copied into the ``(T, R*S*C)`` patch
matrix, as the reference builds its patch matrix outside the kernel. The
patch features are ordered ``(R, S, C)`` — channel innermost, so the copy
reads contiguous channels — which is exactly the HWIO weight reshaped to
``(R*S*C, K)`` with no transpose. (The reference orders its patches
``(C, R, S)`` and transposes its weights to match; the conv output is the
same.) Ragged shapes need no padding: the kernel masks its edges.

``padding`` accepts "SAME"/"VALID" or an explicit ``((top, bottom),
(left, right))`` pair — the executor's blocked lowering slices the vertical
halo itself and passes explicit horizontal pads. Asymmetric pads go through
``F.pad`` before the view, and strided SAME uses the stride-aware
``same_pad``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.hybrid_conv import explicit_pads
from repro_torch.kernels.spatial_conv.kernel import conv_gemm_f32


def im2col(x_nhwc: torch.Tensor, r: int, s: int, stride: int,
           pads) -> tuple[torch.Tensor, tuple[int, int]]:
    """Padded NHWC input -> ((N*HO*WO, R*S*C) contiguous patches, (HO, WO))."""
    (pt, pb), (pl, pr) = pads
    x = F.pad(x_nhwc, (0, 0, pl, pr, pt, pb)).contiguous()
    n, hp, wp, c = x.shape
    ho, wo = (hp - r) // stride + 1, (wp - s) // stride + 1
    sn, sh, sw, sc = x.stride()
    view = x.as_strided((n, ho, wo, r, s, c),
                        (sn, stride * sh, stride * sw, sh, sw, sc))
    # reshape copies only when the patch rows cannot be read as one strided
    # view; a 1x1 strided conv with one output column can (rows a stride
    # apart), so make the result contiguous, as K1 requires
    return view.reshape(n * ho * wo, r * s * c).contiguous(), (ho, wo)


def spatial_conv2d(x_nhwc: torch.Tensor, g_rsck: torch.Tensor,
                   bias: torch.Tensor | None = None, *, stride: int = 1,
                   padding="SAME", relu: bool = False,
                   dataflow: str = "is") -> torch.Tensor:
    """NHWC x HWIO -> NHWC, fp32, through K1."""
    n, h, w, c = x_nhwc.shape
    r, s, _, k = g_rsck.shape
    pads = explicit_pads(padding, h, w, r, s, stride)
    patches, (ho, wo) = im2col(x_nhwc, r, s, stride, pads)
    y = conv_gemm_f32(patches, g_rsck.reshape(r * s * c, k).contiguous(),
                      None if bias is None else bias.contiguous(),
                      relu=relu, dataflow=dataflow)
    return y.reshape(n, ho, wo, k)
