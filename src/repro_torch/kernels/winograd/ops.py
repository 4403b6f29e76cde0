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

:func:`winograd_conv2d` takes raw HWIO weights of any R x S through the
paper's kernel decomposition (Sec. 4.2.5): each 3x3 piece runs K3 on the
same unpadded input at its own (signed) offset, then K2; the pieces' M
tensors are summed (an aten add, as the reference sums them outside
Pallas), and K4 runs once with the bias and ReLU fused.
"""
from __future__ import annotations

import torch

from repro_torch.core.hybrid_conv import explicit_pads
from repro_torch.core.winograd import (
    R_WINO,
    decompose_kernel,
    pt_for,
    transform_weights,
)
from repro_torch.kernels.common import cdiv
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


def winograd_conv2d(
    x_nhwc: torch.Tensor,
    g_rsck: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    m: int = 4,
    padding="SAME",
    relu: bool = False,
    dataflow: str = "is",
) -> torch.Tensor:
    """Winograd F(m x m, 3 x 3) convolution, stride 1, NHWC/HWIO, fp32,
    with raw weights of any R x S.

    ``padding`` is "SAME", "VALID" or explicit ``((top, bottom), (left,
    right))`` pads. The R x S kernel is split into ceil(R/3) x ceil(S/3)
    zero-padded 3x3 pieces (:func:`decompose_kernel`); the piece at offset
    ``(oh, ow)`` reads the window at ``(th m + oh - top, tw m + ow -
    left)`` of x for tile ``(th, tw)``, so K3 takes the pad minus the
    offset, negative for the lower pieces, over the full conv's tile grid.
    """
    n, h, w, c = x_nhwc.shape
    rr, ss, _, k = g_rsck.shape
    (top, bottom), (left, right) = explicit_pads(padding, h, w, rr, ss, 1)
    ho, wo = h + top + bottom - rr + 1, w + left + right - ss + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{h}x{w} padded by {((top, bottom), (left, right))}"
                         f" is smaller than the {rr}x{ss} kernel")
    grid = (cdiv(ho, m), cdiv(wo, m))
    pieces = ([(0, 0, g_rsck)] if (rr, ss) == (R_WINO, R_WINO)
              else decompose_kernel(g_rsck, m))
    pt = pt_for(m)
    # every piece's U = G g G^T in one transform (the pieces side by side
    # on the input-channel axis), then (P, PT^2, C, K)
    u_all = transform_weights(
        torch.cat([sub for _, _, sub in pieces], dim=2), m)
    u_all = u_all.reshape(pt * pt, len(pieces), c, k).transpose(0, 1)
    u_all = u_all.contiguous()
    x = x_nhwc.contiguous()
    m_acc = None
    for (oh, ow, _), u in zip(pieces, u_all):
        v = wino_input_transform_nhwc_f32(
            x, m, ((top - oh, 0), (left - ow, 0)), grid)
        mm = bmm_f32(v, u, dataflow=dataflow)                     # (PT^2, T, K)
        # accumulate in M-space: A^T (sum M) A = sum A^T M A
        m_acc = mm if m_acc is None else m_acc.add_(mm)
    return wino_output_transform_nhwc_f32(
        m_acc, None if bias is None else bias.float().contiguous(), m,
        (n, ho, wo), relu)
