"""Winograd convolution from U-space weights, all three stages on the
Hopper kernels.

Pipeline (the paper's COMP-module datapath, Sec. 4.2):

  tile extract (strided view + copy)           — LOAD manager addressing
  -> wino_input_transform_f32 (K3)             — LOAD manager online B^T d B
  -> bmm_f32, batch PT^2 (K2)                  — the PE, Eq. 2
  -> wino_output_transform_f32 (K4, bias+ReLU) — SAVE manager A^T M A
  -> tile scatter + crop to NHWC               — SAVE manager layout write

The kernels mask their own edges, so unlike the reference nothing is padded
to block multiples; only ``tile_input``'s geometric pad (so the tile grid
covers the output) remains.
"""
from __future__ import annotations

import torch

from repro_torch.core.winograd import R_WINO, pad_for_conv, pt_for, tile_input
from repro_torch.kernels.gemm.kernel import bmm_f32
from repro_torch.kernels.winograd.kernel import (
    wino_input_transform_f32,
    wino_output_transform_f32,
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
    padding: str = "SAME",
    relu: bool = False,
    dataflow: str = "is",
) -> torch.Tensor:
    """Winograd conv from U-space weights (r = s = 3, stride 1), fp32.

    The executor's ``backend="hopper"`` COMP path: tile extract -> K3 ->
    the PT^2-batched K2 GEMM -> K4 with the bias/ReLU epilogue fused ->
    scatter/crop back to NHWC. ``dataflow`` goes to the GEMM's raster order.
    """
    pt, _, c, k = u_ptck.shape
    if pt != pt_for(m):
        raise ValueError(f"U tile {pt} does not match m={m}")
    x = pad_for_conv(x_nhwc, padding)
    n = x.shape[0]
    ho, wo = x.shape[1] - R_WINO + 1, x.shape[2] - R_WINO + 1
    tiles, (nh, nw) = tile_input(x, m)
    t = n * nh * nw
    v = input_transform(tiles.reshape(t, pt, pt, c), m)           # (PT^2, T, C)
    mm = bmm_f32(v, u_ptck.reshape(pt * pt, c, k).contiguous(),
                 dataflow=dataflow)                               # (PT^2, T, K)
    y = output_transform(mm, bias, m, relu)                       # (T, m, m, K)
    y = y.reshape(n, nh, nw, m, m, k).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, nh * m, nw * m, k)[:, :ho, :wo, :]
