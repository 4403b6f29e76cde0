"""Winograd convolution from U-space weights, all three stages on the
Hopper kernels.

Pipeline (the paper's COMP-module datapath, Sec. 4.2):

  wino_input_transform_f32 (K3), NHWC front    — LOAD manager addressing
                                                 and online B^T d B
  -> bmm_f32, batch PT^2 (K2)                  — the PE, Eq. 2
  -> wino_output_transform_f32 (K4), NHWC front — SAVE manager A^T M A
                                                 (bias + ReLU) and layout
                                                 write

K3 reads its tiles straight out of the unpadded input (the pads are
geometry, zeros outside the image) and K4 writes the cropped NHWC output,
so nothing pads, gathers, permutes or crops the activation in between.
"""
from __future__ import annotations

import torch

from repro_torch.core.hybrid_conv import explicit_pads
from repro_torch.core.winograd import R_WINO, pt_for
from repro_torch.kernels.gemm.kernel import bmm_f32
from repro_torch.kernels.winograd.kernel import (
    wino_grid,
    wino_input_transform_f32,
    wino_input_transform_nhwc_f32,
    wino_output_transform_f32,
    wino_output_transform_nhwc_f32,
)


def input_transform(tiles: torch.Tensor, m: int) -> torch.Tensor:
    """(T, PT, PT, C) -> (PT^2, T, C) through K3."""
    return wino_input_transform_f32(tiles.contiguous(), m)


def output_transform(m_arr: torch.Tensor, bias: torch.Tensor | None, m: int,
                     relu: bool = False) -> torch.Tensor:
    """(PT^2, T, K), (K,) -> (T, m, m, K) through K4."""
    return wino_output_transform_f32(
        m_arr.contiguous(), None if bias is None else bias.contiguous(), m,
        relu)


def winograd_apply_pretransformed_hopper(
    x_nhwc: torch.Tensor,
    u_ptck: torch.Tensor,       # (PT, PT, C, K) offline-transformed weights
    bias: torch.Tensor | None = None,
    *,
    m: int = 4,
    padding="SAME",
    relu: bool = False,
    dataflow: str = "is",
) -> torch.Tensor:
    """Winograd conv from U-space weights (r = s = 3, stride 1), fp32.

    The executor's ``backend="hopper"`` COMP path: K3 on the NHWC input ->
    the PT^2-batched K2 GEMM -> K4 with the bias/ReLU epilogue fused, into
    the NHWC output. ``padding`` is "SAME", "VALID" or explicit ``((top,
    bottom), (left, right))`` pads, which K3 takes as geometry.
    ``dataflow`` goes to the GEMM's raster order.
    """
    pt, _, c, k = u_ptck.shape
    if pt != pt_for(m):
        raise ValueError(f"U tile {pt} does not match m={m}")
    n, h, w, _ = x_nhwc.shape
    pad_hw = explicit_pads(padding, h, w, R_WINO, R_WINO, 1)
    ho, wo, _, _ = wino_grid(h, w, m, pad_hw)
    v = wino_input_transform_nhwc_f32(x_nhwc.contiguous(), m, pad_hw)
    mm = bmm_f32(v, u_ptck.reshape(pt * pt, c, k).contiguous(),
                 dataflow=dataflow)                               # (PT^2, T, K)
    return wino_output_transform_nhwc_f32(
        mm, None if bias is None else bias.contiguous(), m, (n, ho, wo), relu)
