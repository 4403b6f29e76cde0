"""The hybrid Spatial/Winograd convolution engine (Sec. 4.2), in PyTorch.

One engine, two CONV modes, two dataflows — the paper's PE. ``backend``
selects the implementation of every block:

* ``"torch"`` — plain aten ops (``F.conv2d``, ``torch.einsum``,
  ``torch.matmul``) on any device; the analog of the reference's ``"xla"``.
* ``"hopper"`` — the hand-written CUDA kernels under
  ``repro_torch.kernels``; the analog of the reference's ``"pallas"``. A
  CPU tensor runs each kernel's plain PyTorch version instead, which is how
  the CPU tests exercise this path's padding, im2col, tiling and crop.

The spec dataclasses are the DSE/compiler currency and match the reference
package field for field, so both packages compile the same ``Program``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn.functional as F

from repro_torch.compat import resolve_backend
from repro_torch.core import winograd as wino

Mode = Literal["spat", "wino"]
Dataflow = Literal["is", "ws"]


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA/TF "SAME" padding for one spatial dim: ``(pad_lo, pad_hi)``.

    The rule is stride-aware — ``total = (ceil(size/stride) - 1) * stride
    + k - size``, low half rounded DOWN — so for an even input under
    stride 2 the padding is asymmetric (e.g. h=32, r=3, stride=2 gives
    (0, 1), NOT the stride-1 rule's (1, 1)). Every place that re-derives
    the conv halo (executor row slicing, compiler LOAD_INP sizing) must
    use this helper, or strided layers shift by a pixel against the
    reference's SAME convolution numerics.
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static description of one CONV layer (the DSE/compiler currency).

    ``inp_from`` reroutes the layer's input: it is the absolute index (in
    the network spec list) of the layer whose OUTPUT this conv reads, or -1
    for the network input; ``None`` (the default) reads the previous layer
    as usual. ResNet projection shortcuts need this — the 1x1 downsample
    conv reads the block INPUT, not the main path's last output.
    """
    name: str
    h: int                  # input spatial height
    w: int
    c: int                  # input channels
    k: int                  # output channels
    r: int = 3              # kernel height
    s: int = 3              # kernel width
    stride: int = 1
    padding: str = "SAME"
    relu: bool = True
    inp_from: int | None = None

    @property
    def out_hw(self) -> tuple[int, int]:
        if self.padding.upper() == "SAME":
            return (-(-self.h // self.stride), -(-self.w // self.stride))
        return ((self.h - self.r) // self.stride + 1,
                (self.w - self.s) // self.stride + 1)

    @property
    def macs(self) -> int:
        ho, wo = self.out_hw
        return self.k * self.c * self.r * self.s * ho * wo

    def wino_eligible(self, m: int = 4) -> bool:
        """Winograd mode requires stride 1 AND an implemented F(m, r)
        transform: the transform set covers m in {2, 4} with r == s == 3
        (paper Sec. 4.2.1/5.1), so a 1x1 projection or 5x5 kernel must take
        the spatial mode in the compiled stack."""
        return (self.stride == 1 and m in wino.SUPPORTED_M
                and self.r == wino.R_WINO and self.s == wino.R_WINO)


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Static description of one max-pooling layer (POOL opcode currency)."""
    name: str
    h: int                  # input spatial height
    w: int
    c: int                  # channels (pooling is depthwise)
    window: int = 2
    stride: int = 2

    @property
    def out_hw(self) -> tuple[int, int]:
        # VALID pooling, the VGG16 convention
        return ((self.h - self.window) // self.stride + 1,
                (self.w - self.window) // self.stride + 1)

    @property
    def macs(self) -> int:
        return 0            # comparisons, not MACs — excluded from GOPS


@dataclasses.dataclass(frozen=True)
class EltwiseSpec:
    """Static description of one residual element-wise add (ELTWISE_ADD).

    ``skip_from`` is the absolute index (in the network spec list) of the
    layer whose OUTPUT is the skip operand, or -1 for the network input.
    The primary operand is — as for every layer — the previous layer's
    output. The compiler's DRAM planner keeps the skip tensor live from its
    producer to this add.
    """
    name: str
    h: int                  # operand spatial height
    w: int
    c: int                  # operand channels (both sources match)
    skip_from: int = -1
    relu: bool = True

    @property
    def out_hw(self) -> tuple[int, int]:
        return (self.h, self.w)

    @property
    def macs(self) -> int:
        return 0            # adds, not MACs — excluded from GOPS


@dataclasses.dataclass(frozen=True)
class DepthwiseSpec:
    """Static description of one depthwise CONV layer (DEPTHWISE_CONV).

    One (r, s) filter per channel — HWIO kernel shaped (r, s, 1, c) with
    ``feature_group_count = c`` — so k == c by construction.
    """
    name: str
    h: int                  # input spatial height
    w: int
    c: int                  # channels (output channels == c)
    r: int = 3
    s: int = 3
    stride: int = 1
    padding: str = "SAME"
    relu: bool = True

    @property
    def out_hw(self) -> tuple[int, int]:
        if self.padding.upper() == "SAME":
            return (-(-self.h // self.stride), -(-self.w // self.stride))
        return ((self.h - self.r) // self.stride + 1,
                (self.w - self.s) // self.stride + 1)

    @property
    def macs(self) -> int:
        ho, wo = self.out_hw
        return self.c * self.r * self.s * ho * wo


@dataclasses.dataclass(frozen=True)
class FCSpec:
    """Static description of one fully-connected layer (FC opcode currency)."""
    name: str
    d_in: int
    d_out: int
    relu: bool = False

    @property
    def macs(self) -> int:
        return self.d_in * self.d_out


def explicit_pads(padding, h: int, w: int, r: int, s: int,
                  stride: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """``"SAME"``/``"VALID"`` or ``((top, bottom), (left, right))`` ->
    explicit pads. SAME is stride-aware (:func:`same_pad`)."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return same_pad(h, r, stride), same_pad(w, s, stride)
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        raise ValueError(f"unknown padding {padding!r}")
    (t, b), (lo, hi) = padding
    return (int(t), int(b)), (int(lo), int(hi))


def _epilogue(y: torch.Tensor, bias, relu: bool) -> torch.Tensor:
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y


def conv2d_torch(x_nhwc: torch.Tensor, g_rsck: torch.Tensor, bias=None, *,
                 stride: int = 1, padding="SAME", relu: bool = False,
                 groups: int = 1) -> torch.Tensor:
    """Direct convolution through ``F.conv2d`` (NHWC in/out, HWIO weights;
    ``groups`` splits the channels as ``F.conv2d``'s does)."""
    r, s = g_rsck.shape[:2]
    (pt, pb), (pl, pr) = explicit_pads(padding, x_nhwc.shape[1],
                                       x_nhwc.shape[2], r, s, stride)
    x = F.pad(x_nhwc.float(), (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    y = F.conv2d(x, g_rsck.float().permute(3, 2, 0, 1), stride=stride,
                 groups=groups)
    return _epilogue(y.permute(0, 2, 3, 1), bias, relu)


def hybrid_conv2d(
    x_nhwc: torch.Tensor,
    g_rsck: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    mode: Mode = "spat",
    m: int = 4,
    dataflow: Dataflow = "is",
    stride: int = 1,
    padding="SAME",
    relu: bool = False,
    backend: str = "torch",
) -> torch.Tensor:
    """Run one convolution on the hybrid PE in the requested mode (fp32).

    Winograd mode runs at stride 1. A 3x3 kernel goes through
    :func:`winograd.transform_weights` and then the pretransformed path,
    exactly as the executor runs U-space weights from DRAM; any other R x S
    through the kernel decomposition (``winograd_conv2d_reference`` on
    ``"torch"``, ``kernels.winograd.winograd_conv2d`` on ``"hopper"``).
    """
    resolve_backend(backend)
    if backend == "torch" and dataflow != "is":
        # the aten lowering is dataflow-oblivious; a non-default value would
        # be silently ignored
        raise ValueError(
            f"dataflow={dataflow!r} has no effect with backend='torch'; "
            f"pass backend='hopper' or drop dataflow=")
    if mode == "wino":
        if stride != 1:
            raise ValueError("Winograd mode requires stride 1")
        if not isinstance(padding, str):
            raise ValueError("Winograd mode takes 'SAME' or 'VALID' padding")
        if tuple(g_rsck.shape[:2]) != (wino.R_WINO, wino.R_WINO):
            if backend == "hopper":
                from repro_torch.kernels.winograd import winograd_conv2d
                return winograd_conv2d(x_nhwc, g_rsck, bias, m=m,
                                       padding=padding, relu=relu,
                                       dataflow=dataflow)
            y = wino.winograd_conv2d_reference(x_nhwc, g_rsck, m=m,
                                               padding=padding)
            return _epilogue(y, bias, relu)
        u = wino.transform_weights(g_rsck, m)
        if backend == "hopper":
            from repro_torch.kernels.winograd import (
                winograd_apply_pretransformed_hopper,
            )
            return winograd_apply_pretransformed_hopper(
                x_nhwc, u, bias, m=m, padding=padding, relu=relu,
                dataflow=dataflow)
        return wino.winograd_apply_pretransformed(
            x_nhwc, u, bias, m, relu=relu, padding=padding)
    if mode == "spat":
        if backend == "hopper":
            from repro_torch.kernels.spatial_conv import spatial_conv2d
            return spatial_conv2d(x_nhwc, g_rsck, bias, stride=stride,
                                  padding=padding, relu=relu,
                                  dataflow=dataflow)
        return conv2d_torch(x_nhwc, g_rsck, bias, stride=stride,
                            padding=padding, relu=relu)
    raise ValueError(f"unknown mode {mode!r}")


def depthwise_conv2d(x_nhwc: torch.Tensor, g_rs1c: torch.Tensor,
                     bias: torch.Tensor | None = None, *, stride: int = 1,
                     padding="SAME", relu: bool = False,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Depthwise convolution: one (r, s) filter per channel, HWIO kernel
    ``(r, s, 1, C)``, fp32 accumulate. Like POOL it is element-parallel
    work, not a PE GEMM, so both backends run this one aten op (a grouped
    ``F.conv2d``). SAME is padded explicitly (stride-aware, asymmetric
    under stride 2 on even maps, as the reference's ``"SAME"``)."""
    _, _, one, c = g_rs1c.shape
    if one != 1 or c != x_nhwc.shape[-1]:
        raise ValueError(
            f"depthwise kernel must be (r, s, 1, C={x_nhwc.shape[-1]}), "
            f"got {tuple(g_rs1c.shape)}")
    y = conv2d_torch(x_nhwc, g_rs1c, bias, stride=stride, padding=padding,
                     relu=relu, groups=c)
    return y.to(out_dtype or x_nhwc.dtype)


def max_pool2d(x_nhwc: torch.Tensor, window: int = 2,
               stride: int = 2) -> torch.Tensor:
    """VALID max pooling, NHWC in/out, any dtype: floats go through
    ``F.max_pool2d``; integer maps (int8 activations, which CUDA's
    ``max_pool2d`` does not take) take the max over the window's strided
    views, which is exact."""
    if x_nhwc.dtype.is_floating_point:
        y = F.max_pool2d(x_nhwc.permute(0, 3, 1, 2), window, stride)
        return y.permute(0, 2, 3, 1)
    _, h, w, _ = x_nhwc.shape
    ho, wo = (h - window) // stride + 1, (w - window) // stride + 1
    y = None
    for i in range(window):
        for j in range(window):
            v = x_nhwc[:, i:i + stride * (ho - 1) + 1:stride,
                       j:j + stride * (wo - 1) + 1:stride]
            y = v if y is None else torch.maximum(y, v)
    return y.contiguous()


def dense(x: torch.Tensor, w_ck: torch.Tensor,
          bias: torch.Tensor | None = None, relu: bool = False,
          backend: str = "torch") -> torch.Tensor:
    """FC layer; the matmul routes through the shared GEMM PE on
    ``backend="hopper"``, and bias/ReLU follow it on both backends."""
    resolve_backend(backend)
    if backend == "hopper":
        from repro_torch.kernels.gemm import matmul
        y = matmul(x.float(), w_ck.float())
    else:
        y = torch.matmul(x.float(), w_ck.float())
    return _epilogue(y, bias, relu)
