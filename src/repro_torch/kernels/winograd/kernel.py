"""K3 ``wino_input_transform_f32`` and K4 ``wino_output_transform_f32``.

Replace ``src/repro/kernels/winograd/kernel.py::input_transform_kernel``
(tiles ``(T, PT, PT, C)`` -> ``V = B^T d B`` laid out ``(PT^2, T, C)``) and
``::output_transform_kernel`` (``M (PT^2, T, K)`` -> ``Y = A^T M A`` laid out
``(T, m, m, K)``, with the bias add and ReLU fused). The CUDA kernels live
in ``csrc/winograd_f32.cu``; their note says what bounds them and what the
design does about that.

Each kernel takes NHWC geometry, so each has two fronts:

* the reference's contract, on the tiles layouts
  (:func:`wino_input_transform_f32`, :func:`wino_output_transform_f32`);
* the Winograd PE's, on the images themselves
  (:func:`wino_input_transform_nhwc_f32` reads the tiles straight out of the
  unpadded input, :func:`wino_output_transform_nhwc_f32` writes the cropped
  NHWC output), so nothing pads, gathers, permutes or crops in between.

Both fronts of a kernel count under its one ``LAUNCHES`` key, and
``common.last_route`` names the route it took: ``vec4`` (float4 accesses,
for channels in fours and 16-byte aligned operands) or ``scalar``. Each
front has its plain PyTorch version beside it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.winograd import (
    R_WINO,
    SUPPORTED_M,
    pt_for,
    tile_input,
    transform_matrices,
)
from repro_torch.kernels.common import cdiv, counted, launch, on_cpu, traced

Pads = tuple[tuple[int, int], tuple[int, int]]
NO_PAD: Pads = ((0, 0), (0, 0))


def _check_m(m: int):
    if m not in SUPPORTED_M:
        raise ValueError(f"Winograd m must be one of {SUPPORTED_M}, got {m}")


def wino_grid(h: int, w: int, m: int, pad_hw: Pads = NO_PAD
              ) -> tuple[int, int, int, int]:
    """``(Ho, Wo, nh, nw)``: the output of a VALID 3x3 convolution of an
    ``h x w`` image padded by ``pad_hw = ((top, bottom), (left, right))``,
    and the ``nh x nw`` grid of m x m tiles that covers it."""
    (top, bottom), (left, right) = pad_hw
    ho, wo = h + top + bottom - R_WINO + 1, w + left + right - R_WINO + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{h}x{w} padded by {pad_hw} is smaller than the "
                         f"{R_WINO}x{R_WINO} kernel")
    return ho, wo, cdiv(ho, m), cdiv(wo, m)


# ---------------------------------------------------------------------------
# K3: the input transform
# ---------------------------------------------------------------------------

def wino_input_transform_ref(tiles: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`wino_input_transform_f32`."""
    bt = torch.from_numpy(transform_matrices(m)[0]).to(tiles.device)
    t, pt, _, c = tiles.shape
    v = torch.einsum("ip,tpqc,jq->ijtc", bt, tiles, bt)
    return v.reshape(pt * pt, t, c)


def signed_offset_tiles(x: torch.Tensor, m: int, top: int, left: int,
                        grid: tuple[int, int]) -> torch.Tensor:
    """The (T, PT, PT, C) windows K3 reads over an explicit tile ``grid``
    with x at the signed offset ``(top, left)``, zeros outside x: cut out
    of a zero canvas the grid covers."""
    n, h, w, c = x.shape
    pt = pt_for(m)
    nh, nw = grid
    hp, wp = (nh - 1) * m + pt, (nw - 1) * m + pt
    canvas = x.new_zeros((n, hp, wp, c))
    # x's rows and columns that land on the canvas
    y0, y1 = max(0, -top), min(h, hp - top)
    x0, x1 = max(0, -left), min(w, wp - left)
    if y0 < y1 and x0 < x1:
        canvas[:, y0 + top:y1 + top, x0 + left:x1 + left] = x[:, y0:y1,
                                                              x0:x1]
    tiles = canvas.unfold(1, pt, m).unfold(2, pt, m).permute(0, 1, 2, 4, 5, 3)
    return tiles.reshape(-1, pt, pt, c)


def wino_input_transform_nhwc_ref(x: torch.Tensor, m: int,
                                  pad_hw: Pads = NO_PAD,
                                  grid: tuple[int, int] | None = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of :func:`wino_input_transform_nhwc_f32`:
    ``F.pad``, ``tile_input`` and the einsum; with an explicit ``grid``,
    :func:`signed_offset_tiles` and the einsum."""
    pt, c = pt_for(m), x.shape[3]
    (top, bottom), (left, right) = pad_hw
    if grid is None:
        tiles, _ = tile_input(F.pad(x, (0, 0, left, right, top, bottom)), m)
        return wino_input_transform_ref(tiles.reshape(-1, pt, pt, c), m)
    return wino_input_transform_ref(
        signed_offset_tiles(x, m, top, left, grid), m)


def wino_input_work(t: int, c: int, m: int,
                    in_floats: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one K3 call over ``t`` tiles of ``c`` channels:
    B^T d and (B^T d) B as dense PT x PT products; ``in_floats`` of x read
    once, V (PT^2, T, C) written once."""
    pt = pt_for(m)
    return 4.0 * pt ** 3 * t * c, 4.0 * (in_floats + pt * pt * t * c)


def wino_output_work(t: int, k: int, m: int, out_floats: int,
                     has_bias: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of one K4 call over ``t`` tiles of ``k`` channels:
    A^T M and (A^T M) A as dense products; M and the bias read once,
    ``out_floats`` of Y written once."""
    pt = pt_for(m)
    return (2.0 * (m * pt * pt + m * m * pt) * t * k,
            4.0 * (pt * pt * t * k + (k if has_bias else 0) + out_floats))


def _launch_input(x: torch.Tensor, m: int, geom: tuple[int, ...],
                  t: int) -> torch.Tensor:
    """K3 on x (N, H, W, C) with ``geom`` = (N, H, W, C, pad top, pad left,
    nh, nw): V (PT^2, T, C)."""
    pt, c = pt_for(m), geom[3]
    out = torch.empty((pt * pt, t, c), dtype=torch.float32, device=x.device)
    if out.numel():
        launch("wino_input_transform_f32", [x, out], [*geom, m],
               route_args=(x.data_ptr(), out.data_ptr(), None, c))
    return out


def wino_input_transform_f32(tiles: torch.Tensor, m: int) -> torch.Tensor:
    """(T, PT, PT, C) -> V (PT^2, T, C), PT = m + 2, fp32: the reference's
    contract (its tiles are K3's images with N = T, H = W = PT, no pad, one
    tile each)."""
    _check_m(m)
    pt = pt_for(m)
    if tiles.dim() != 4 or tiles.shape[1:3] != (pt, pt):
        raise ValueError(f"tiles must be (T, {pt}, {pt}, C), got {tiles.shape}")
    cpu = on_cpu("wino_input_transform_f32", tiles)
    t, _, _, c = tiles.shape
    with counted("wino_input_transform_f32", wino_input_work, t, c, m,
                 tiles.numel(), on=tiles.device):
        if cpu:
            return wino_input_transform_ref(tiles, m)
        return _launch_input(tiles, m, (t, pt, pt, c, 0, 0, 1, 1), t)


def wino_input_transform_nhwc_f32(x: torch.Tensor, m: int,
                                  pad_hw: Pads = NO_PAD,
                                  grid: tuple[int, int] | None = None
                                  ) -> torch.Tensor:
    """x (N, H, W, C), fp32 -> V (PT^2, N nh nw, C): the input transform of
    every tile that ``tile_input(F.pad(x, pad_hw), m)`` would form, read
    straight out of x (zeros outside it); ``(nh, nw)`` from
    :func:`wino_grid`.

    With an explicit ``grid = (nh, nw)``, tile ``(th, tw)`` is the PT x PT
    window at ``(th m - top, tw m - left)`` of x, and the pads above and to
    the left may be negative: a shifted window, as each piece of a
    decomposed kernel reads (``ops.winograd_conv2d``); the pads below and to
    the right are then unused."""
    _check_m(m)
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {x.shape}")
    n, h, w, c = x.shape
    if grid is None:
        if min(min(p) for p in pad_hw) < 0:
            raise ValueError(f"pads must be >= 0 without a grid, got "
                             f"{pad_hw}")
        _, _, nh, nw = wino_grid(h, w, m, pad_hw)
    else:
        nh, nw = (int(v) for v in grid)
        if nh < 1 or nw < 1:
            raise ValueError(f"grid must be at least 1 x 1, got {grid}")
    (top, _), (left, _) = pad_hw
    if traced(x):
        return torch.ops.repro_torch.wino_input_transform_nhwc_f32(
            x, m, top, left, nh, nw)
    cpu = on_cpu("wino_input_transform_f32", x)
    with counted("wino_input_transform_f32", wino_input_work, n * nh * nw,
                 c, m, x.numel(), on=x.device):
        if cpu:
            return wino_input_transform_nhwc_ref(x, m, pad_hw, grid)
        return _launch_input(x, m, (n, h, w, c, top, left, nh, nw),
                             n * nh * nw)


# ---------------------------------------------------------------------------
# K4: the output transform (+ bias, ReLU)
# ---------------------------------------------------------------------------

def wino_output_transform_ref(m_arr: torch.Tensor,
                              bias: torch.Tensor | None, m: int,
                              relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`wino_output_transform_f32`."""
    at = torch.from_numpy(transform_matrices(m)[2]).to(m_arr.device)
    pt = pt_for(m)
    _, t, k = m_arr.shape
    y = torch.einsum("ip,pqtk,jq->tijk", at, m_arr.reshape(pt, pt, t, k), at)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def wino_output_transform_nhwc_ref(m_arr: torch.Tensor,
                                   bias: torch.Tensor | None, m: int,
                                   out_nhw: tuple[int, int, int],
                                   relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`wino_output_transform_nhwc_f32`:
    the einsum, then the tile scatter and the crop."""
    n, ho, wo = out_nhw
    nh, nw = cdiv(ho, m), cdiv(wo, m)
    k = m_arr.shape[2]
    y = wino_output_transform_ref(m_arr, bias, m, relu)
    y = y.reshape(n, nh, nw, m, m, k).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, nh * m, nw * m, k)[:, :ho, :wo].contiguous()


def _check_output(m_arr: torch.Tensor, bias: torch.Tensor | None, m: int):
    _check_m(m)
    pt = pt_for(m)
    if m_arr.dim() != 3 or m_arr.shape[0] != pt * pt:
        raise ValueError(f"M must be ({pt * pt}, T, K), got {m_arr.shape}")
    k = m_arr.shape[2]
    if bias is not None and bias.shape != (k,):
        raise ValueError(f"bias must be {(k,)}, got {bias.shape}")


def _launch_output(m_arr: torch.Tensor, bias: torch.Tensor | None, m: int,
                   relu: bool, out: torch.Tensor,
                   geom: tuple[int, ...]) -> torch.Tensor:
    """K4 into ``out`` with ``geom`` = (N, Ho, Wo, K, nh, nw)."""
    if out.numel():
        launch("wino_output_transform_f32", [m_arr, bias, out],
               [*geom, m, relu],
               route_args=(m_arr.data_ptr(), out.data_ptr(),
                           None if bias is None else bias.data_ptr(),
                           geom[3]))
    return out


def wino_output_transform_f32(m_arr: torch.Tensor,
                              bias: torch.Tensor | None, m: int,
                              relu: bool = False) -> torch.Tensor:
    """M (PT^2, T, K) [+ bias (K,)] [ReLU] -> Y (T, m, m, K), fp32: the
    reference's contract (K4's output images with N = T, Ho = Wo = m, one
    tile each)."""
    _check_output(m_arr, bias, m)
    cpu = on_cpu("wino_output_transform_f32", m_arr, bias)
    _, t, k = m_arr.shape
    with counted("wino_output_transform_f32", wino_output_work, t, k, m,
                 t * m * m * k, bias is not None, on=m_arr.device):
        if cpu:
            return wino_output_transform_ref(m_arr, bias, m, relu)
        out = torch.empty((t, m, m, k), dtype=torch.float32,
                          device=m_arr.device)
        return _launch_output(m_arr, bias, m, relu, out, (t, m, m, k, 1, 1))


def wino_output_transform_nhwc_f32(m_arr: torch.Tensor,
                                   bias: torch.Tensor | None, m: int,
                                   out_nhw: tuple[int, int, int],
                                   relu: bool = False) -> torch.Tensor:
    """M (PT^2, N nh nw, K) [+ bias (K,)] [ReLU] -> Y (N, Ho, Wo, K), fp32,
    ``out_nhw = (N, Ho, Wo)``: each tile's m x m outputs written into the
    NHWC image where ``transform_output`` and the crop place them."""
    _check_output(m_arr, bias, m)
    n, ho, wo = out_nhw
    nh, nw = cdiv(ho, m), cdiv(wo, m)
    _, t, k = m_arr.shape
    if min(out_nhw) < 1 or t != n * nh * nw:
        raise ValueError(f"M holds {t} tiles; an (N, Ho, Wo) = {out_nhw} "
                         f"output takes {n * nh * nw}")
    if traced(m_arr):
        return torch.ops.repro_torch.wino_output_transform_nhwc_f32(
            m_arr, bias, m, n, ho, wo, relu)
    cpu = on_cpu("wino_output_transform_f32", m_arr, bias)
    with counted("wino_output_transform_f32", wino_output_work, t, k, m,
                 n * ho * wo * k, bias is not None, on=m_arr.device):
        if cpu:
            return wino_output_transform_nhwc_ref(m_arr, bias, m, out_nhw,
                                                  relu)
        return _launch_output_nhwc(m_arr, bias, m, (n, ho, wo), relu)


def _launch_output_nhwc(m_arr: torch.Tensor, bias: torch.Tensor | None,
                        m: int, out_nhw: tuple[int, int, int],
                        relu: bool) -> torch.Tensor:
    n, ho, wo = out_nhw
    k = m_arr.shape[2]
    out = torch.empty((n, ho, wo, k), dtype=torch.float32,
                      device=m_arr.device)
    return _launch_output(m_arr, bias, m, relu, out,
                          (n, ho, wo, k, cdiv(ho, m), cdiv(wo, m)))


# ---------------------------------------------------------------------------
# The exportable ops of the NHWC fronts: CPU runs the plain versions, CUDA
# the same launches
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::wino_input_transform_nhwc_f32",
                         mutates_args=(), device_types="cpu")
def _input_op(x: torch.Tensor, m: int, top: int, left: int, nh: int,
              nw: int) -> torch.Tensor:
    return wino_input_transform_nhwc_ref(x, m, ((top, 0), (left, 0)),
                                         (nh, nw))


@_input_op.register_kernel("cuda")
def _(x, m, top, left, nh, nw):
    n, h, w, c = x.shape
    on_cpu("wino_input_transform_f32", x)
    return _launch_input(x, m, (n, h, w, c, top, left, nh, nw), n * nh * nw)


@_input_op.register_fake
def _(x, m, top, left, nh, nw):
    return x.new_empty((pt_for(m) ** 2, x.shape[0] * nh * nw, x.shape[3]))


@torch.library.custom_op("repro_torch::wino_output_transform_nhwc_f32",
                         mutates_args=(), device_types="cpu")
def _output_op(m_arr: torch.Tensor, bias: Optional[torch.Tensor], m: int,
               n: int, ho: int, wo: int, relu: bool) -> torch.Tensor:
    return wino_output_transform_nhwc_ref(m_arr, bias, m, (n, ho, wo), relu)


@_output_op.register_kernel("cuda")
def _(m_arr, bias, m, n, ho, wo, relu):
    on_cpu("wino_output_transform_f32", m_arr, bias)
    return _launch_output_nhwc(m_arr, bias, m, (n, ho, wo), relu)


@_output_op.register_fake
def _(m_arr, bias, m, n, ho, wo, relu):
    return m_arr.new_empty((n, ho, wo, m_arr.shape[2]))
