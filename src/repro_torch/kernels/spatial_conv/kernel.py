"""K1, the Spatial-mode PE: a patch GEMM, two entries.

Replaces ``src/repro/kernels/spatial_conv/kernel.py::conv_gemm_kernel``:
``(T, C*R*S) @ (C*R*S, K)`` with fp32 accumulation and the bias add plus
optional ReLU fused at the store. The CUDA kernel lives in
``csrc/gemm_f32.cu`` and shares its bodies with K2: 3xTF32 on the tensor
cores (``wgmma``) where M >= 64, CRS and K are multiples of 4 and the
operands 16-byte aligned, the fp32 FMA pipes else (K = 27 of the first
CONV); ``common.last_route`` names the route of the last launch. Its note
says what bounds it and what the design does about that. The IS/WS dataflow
maps to the raster order of output tiles and changes no numbers.

``conv_gemm_f32`` takes a patch matrix (:func:`im2col`).
``conv_implicit_f32`` takes the NHWC map itself, as it lies, and the pads
as numbers: its tensor-core body finds each 16-byte chunk of a patch in the
map (zeros outside it), so neither a padded copy of the map nor the patch
matrix is written. It runs where :func:`takes_implicit` holds, with the
patch GEMM's plan, so its output is ``conv_gemm_f32``'s over ``im2col``'s
patches bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import (
    counted,
    gemm_workspace,
    launch_gemm,
    on_cpu,
    traced,
)


def im2col(x_nhwc: torch.Tensor, r: int, s: int, stride: int,
           pads) -> tuple[torch.Tensor, tuple[int, int]]:
    """NHWC input and its pads -> ((N*HO*WO, R*S*C) contiguous patches,
    (HO, WO)): one strided view of the padded input copied into the patch
    matrix, features ordered ``(R, S, C)``."""
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


def conv_gemm_ref(patches: torch.Tensor, weights: torch.Tensor,
                  bias: torch.Tensor | None = None, relu: bool = False,
                  dataflow: str = "is") -> torch.Tensor:
    """Plain PyTorch version of :func:`conv_gemm_f32` (same signature)."""
    y = patches @ weights
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def conv_gemm_work(t: int, crs: int, k: int,
                   has_bias: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of one (T, CRS) @ (CRS, K) call: a multiply-add per
    product; P, W and the bias read once, Y written once."""
    return (2.0 * t * crs * k,
            4.0 * (t * crs + crs * k + t * k + (k if has_bias else 0)))


def _launch(patches: torch.Tensor, weights: torch.Tensor,
            bias: torch.Tensor | None, relu: bool, ws: bool) -> torch.Tensor:
    t, crs = patches.shape
    k = weights.shape[1]
    out = torch.empty((t, k), dtype=torch.float32, device=patches.device)
    if out.numel():
        launch_gemm("conv_gemm_f32",
                    [patches, weights, bias, out,
                     gemm_workspace(1, t, crs, k, patches.device)],
                    [t, crs, k, relu, ws],
                    (1, t, crs, k, patches.device.index))
    return out


def conv_gemm_f32(patches: torch.Tensor, weights: torch.Tensor,
                  bias: torch.Tensor | None = None, relu: bool = False,
                  dataflow: str = "is") -> torch.Tensor:
    """(T, CRS) @ (CRS, K) [+ bias (K,)] [ReLU] -> (T, K), fp32."""
    if dataflow not in ("is", "ws"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if patches.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"conv_gemm_f32 takes 2-D operands, got "
                         f"{patches.shape}, {weights.shape}")
    crs = patches.shape[1]
    if weights.shape[0] != crs:
        raise ValueError(f"conv_gemm_f32 shape mismatch: {patches.shape} @ "
                         f"{weights.shape}")
    k = weights.shape[1]
    if bias is not None and bias.shape != (k,):
        raise ValueError(f"conv_gemm_f32 bias must be {(k,)}, got {bias.shape}")
    if traced(patches):
        return torch.ops.repro_torch.conv_gemm_f32(
            patches, weights, bias, relu, dataflow == "ws")
    cpu = on_cpu("conv_gemm_f32", patches, weights, bias)
    with counted("conv_gemm_f32", conv_gemm_work, patches.shape[0], crs, k,
                 bias is not None, on=patches.device):
        if cpu:
            return conv_gemm_ref(patches, weights, bias, relu, dataflow)
        return _launch(patches, weights, bias, relu, dataflow == "ws")


# the exportable op: CPU runs the plain version, CUDA the same launch
@torch.library.custom_op("repro_torch::conv_gemm_f32", mutates_args=(),
                         device_types="cpu")
def _conv_gemm_op(patches: torch.Tensor, weights: torch.Tensor,
                  bias: Optional[torch.Tensor], relu: bool,
                  ws: bool) -> torch.Tensor:
    return conv_gemm_ref(patches, weights, bias, relu)


@_conv_gemm_op.register_kernel("cuda")
def _(patches, weights, bias, relu, ws):
    on_cpu("conv_gemm_f32", patches, weights, bias)
    return _launch(patches, weights, bias, relu, ws)


@_conv_gemm_op.register_fake
def _(patches, weights, bias, relu, ws):
    return patches.new_empty((patches.shape[0], weights.shape[1]))


# ---------------------------------------------------------------------------
# conv_implicit_f32: K1 over the map itself
# ---------------------------------------------------------------------------

def out_hw(h: int, w: int, r: int, s: int, stride: int,
           pads) -> tuple[int, int]:
    """(HO, WO) of an R x S conv over an H x W map with explicit pads."""
    (pt, pb), (pl, pr) = pads
    return (h + pt + pb - r) // stride + 1, (w + pl + pr - s) // stride + 1


# the largest size csrc/gemm_f32.cu's conv_implicit_f32 indexes in 32 bits
_MAX_INDEX = (2 ** 31 - 1) // 4


def _aligned16(t: torch.Tensor) -> bool:
    # a traced tensor has no address: its storage starts aligned, as every
    # allocation does, so its offset decides
    if traced(t):
        return t.storage_offset() % 4 == 0
    return t.data_ptr() % 16 == 0


def takes_implicit(x_nhwc: torch.Tensor, g_rsck: torch.Tensor, stride: int,
                   pads) -> bool:
    """True where K1 reads its patches from the map itself
    (:func:`conv_implicit_f32`), False where it takes ``im2col``'s patches
    (:func:`conv_gemm_f32`). Shape and alignment alone decide, as in
    ``csrc/gemm_f32.cu``: the patch GEMM would take the tensor-core route
    (M = N*HO*WO >= 64, R*S*C and K multiples of 4), C % 4 == 0 (a 16-byte
    chunk stays in one tap), the pads are not negative, the map's channels
    are contiguous and its N, H, W strides multiples of 4 floats, the map
    and the (R, S, C, K) weights 16-byte aligned, and the sizes fit the
    kernel's 32-bit index arithmetic. (The output and the workspace are
    fresh allocations, aligned.) So the first CONV (C = 3) and the M < 64
    GEMMs keep the patches."""
    n, h, w, c = x_nhwc.shape
    r, s, _, k = g_rsck.shape
    ho, wo = out_hw(h, w, r, s, stride, pads)
    return (c % 4 == 0 and k % 4 == 0 and ho > 0 and wo > 0
            and n * ho * wo >= 64 and min(min(p) for p in pads) >= 0
            and max(h, w, r * s * c, n * ho * wo, (ho - 1) * stride + r,
                    (wo - 1) * stride + s, *pads[0], *pads[1]) <= _MAX_INDEX
            and x_nhwc.stride(3) == 1
            and all(st % 4 == 0 for st in x_nhwc.stride()[:3])
            and g_rsck.is_contiguous()
            and _aligned16(x_nhwc) and _aligned16(g_rsck))


def conv_implicit_ref(x_nhwc: torch.Tensor, g_rsck: torch.Tensor,
                      bias: torch.Tensor | None = None, *, stride: int = 1,
                      pads=((0, 0), (0, 0)), relu: bool = False,
                      dataflow: str = "is") -> torch.Tensor:
    """Plain PyTorch version of :func:`conv_implicit_f32` (same signature):
    the patches built, then :func:`conv_gemm_ref`."""
    r, s, c, k = g_rsck.shape
    patches, (ho, wo) = im2col(x_nhwc, r, s, stride, pads)
    y = conv_gemm_ref(patches, g_rsck.reshape(r * s * c, k), bias, relu)
    return y.reshape(x_nhwc.shape[0], ho, wo, k)


def conv_implicit_work(n: int, h: int, w: int, c: int, k: int, r: int,
                       s: int, ho: int, wo: int,
                       has_bias: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: the patch GEMM's multiply-adds; the map,
    W and the bias read once, Y written once."""
    t = n * ho * wo
    return (2.0 * t * r * s * c * k,
            4.0 * (n * h * w * c + r * s * c * k + t * k
                   + (k if has_bias else 0)))


def _launch_implicit(x: torch.Tensor, g: torch.Tensor,
                     bias: torch.Tensor | None, stride: int, pads,
                     relu: bool, ws: bool) -> torch.Tensor:
    n, h, w, c = x.shape
    r, s, _, k = g.shape
    ho, wo = out_hw(h, w, r, s, stride, pads)
    (pt, _), (pl, _) = pads
    out = torch.empty((n, ho, wo, k), dtype=torch.float32, device=x.device)
    t, crs = n * ho * wo, r * s * c
    launch_gemm("conv_implicit_f32",
                [x, g, bias, out, gemm_workspace(1, t, crs, k, x.device)],
                [*x.stride()[:3], n, h, w, c, k, r, s, stride, pt, pl, ho,
                 wo, relu, ws],
                (1, t, crs, k, x.device.index))
    return out


def conv_implicit_f32(x_nhwc: torch.Tensor, g_rsck: torch.Tensor,
                      bias: torch.Tensor | None = None, *, stride: int = 1,
                      pads=((0, 0), (0, 0)), relu: bool = False,
                      dataflow: str = "is") -> torch.Tensor:
    """NHWC map (N, H, W, C) x HWIO (R, S, C, K) [+ bias (K,)] [ReLU] ->
    (N, HO, WO, K), fp32, pads ``((top, bottom), (left, right))``: K1
    reading its patches from the map. Raises where :func:`takes_implicit`
    does not hold."""
    if dataflow not in ("is", "ws"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if x_nhwc.dim() != 4 or g_rsck.dim() != 4:
        raise ValueError(f"conv_implicit_f32 takes NHWC and HWIO operands, "
                         f"got {x_nhwc.shape}, {g_rsck.shape}")
    if g_rsck.shape[2] != x_nhwc.shape[3]:
        raise ValueError(f"conv_implicit_f32 channel mismatch: "
                         f"{x_nhwc.shape} * {g_rsck.shape}")
    k = g_rsck.shape[3]
    if bias is not None and bias.shape != (k,):
        raise ValueError(f"conv_implicit_f32 bias must be {(k,)}, got "
                         f"{bias.shape}")
    pads = tuple(tuple(int(p) for p in pair) for pair in pads)
    if not takes_implicit(x_nhwc, g_rsck, stride, pads):
        raise ValueError(
            f"conv_implicit_f32 does not take {tuple(x_nhwc.shape)} "
            f"(strides {x_nhwc.stride()}) * {tuple(g_rsck.shape)}, stride "
            f"{stride}, pads {pads}: see takes_implicit")
    if traced(x_nhwc):
        (pt, pb), (pl, pr) = pads
        return torch.ops.repro_torch.conv_implicit_f32(
            x_nhwc, g_rsck, bias, stride, [pt, pb, pl, pr], relu,
            dataflow == "ws")
    cpu = on_cpu("conv_implicit_f32", x_nhwc, g_rsck, bias, strided=1)
    n, h, w, c = x_nhwc.shape
    r, s = g_rsck.shape[:2]
    with counted("conv_implicit_f32", conv_implicit_work, n, h, w, c, k, r,
                 s, *out_hw(h, w, r, s, stride, pads), bias is not None,
                 on=x_nhwc.device):
        if cpu:
            return conv_implicit_ref(x_nhwc, g_rsck, bias, stride=stride,
                                     pads=pads, relu=relu)
        return _launch_implicit(x_nhwc, g_rsck, bias, stride, pads, relu,
                                dataflow == "ws")


def _pairs(pads: list[int]):
    return (pads[0], pads[1]), (pads[2], pads[3])


# the exportable op: CPU runs the plain version, CUDA the same launch
@torch.library.custom_op("repro_torch::conv_implicit_f32", mutates_args=(),
                         device_types="cpu")
def _conv_implicit_op(x: torch.Tensor, weights: torch.Tensor,
                      bias: Optional[torch.Tensor], stride: int,
                      pads: list[int], relu: bool, ws: bool) -> torch.Tensor:
    return conv_implicit_ref(x, weights, bias, stride=stride,
                             pads=_pairs(pads), relu=relu)


@_conv_implicit_op.register_kernel("cuda")
def _(x, weights, bias, stride, pads, relu, ws):
    on_cpu("conv_implicit_f32", x, weights, bias, strided=1)
    return _launch_implicit(x, weights, bias, stride, _pairs(pads), relu, ws)


@_conv_implicit_op.register_fake
def _(x, weights, bias, stride, pads, relu, ws):
    r, s, _, k = weights.shape
    ho, wo = out_hw(x.shape[1], x.shape[2], r, s, stride, _pairs(pads))
    return x.new_empty((x.shape[0], ho, wo, k))
