"""ResNet-18 — the residual workload the ELTWISE_ADD opcode exists for.

Standard basic-block topology: a 3x3 stem + 2x2 maxpool, four stages of
two basic blocks (stages 2-4 open with a stride-2 block whose shortcut is a
1x1 projection conv), then flatten -> FC. No global average pool: the ISA
has no reduction opcode, so the classifier reads the flattened last map.
The spec builder is identical to the reference package's, so both packages
run the same DSE and compile the same ``Program``. Cross-layer wiring is
explicit: a strided block's projection conv and its first 3x3 conv both
read the block input (``ConvSpec.inp_from``), and every block's
``EltwiseSpec.skip_from`` names the shortcut producer.

Full width is ``resnet18_specs(128, 1, n_classes=1000)``: the published
channel widths 64-512 at the largest power-of-two resolution whose
flattened FC input (8 * 8 * 512 = 32768) the ISA's 16-bit FC dims accept.

``replay_stash`` walks any spec chain with plain fp32 ops and keeps every
intermediate; ``reference_forward`` (the executor-independent oracle) and
the int8 calibration (``quant.calibrate``) both use it.
"""
from __future__ import annotations

import torch

from repro_torch.core.hybrid_conv import (
    ConvSpec,
    DepthwiseSpec,
    EltwiseSpec,
    FCSpec,
    PoolSpec,
    dense,
    depthwise_conv2d,
    hybrid_conv2d,
    max_pool2d,
)

# blocks per stage — the "18" in ResNet-18 (2-2-2-2 basic blocks)
_STAGES = (2, 2, 2, 2)


def resnet18_specs(img: int = 64, scale: int = 8, *, n_classes: int = 10
                   ) -> list:
    """ResNet-18 as one compilable spec chain (30 layers: 20 CONV,
    8 ELTWISE_ADD, 1 POOL, 1 FC).

    ``scale`` divides the channel widths (base width 64 // scale); ``img``
    is the input resolution and must be divisible by 16 (one maxpool plus
    three stride-2 stages).
    """
    if img % 16:
        raise ValueError(f"img={img} must be divisible by 16 "
                         f"(2x2 maxpool + three stride-2 stages)")
    w0 = max(4, 64 // scale)
    specs: list = []

    def lid() -> int:
        return len(specs) - 1

    # stem: 3x3 conv + 2x2 maxpool (no 7x7: the ISA's COMP path is 3x3)
    specs.append(ConvSpec("stem", img, img, 3, w0, relu=True))
    specs.append(PoolSpec("stem_pool", img, img, w0))
    hw, c = img // 2, w0

    for si, n_blocks in enumerate(_STAGES):
        width = w0 * (2 ** si)
        for bi in range(n_blocks):
            tag = f"s{si + 1}b{bi + 1}"
            strided = si > 0 and bi == 0
            block_in = lid()
            if strided:
                # shortcut: 1x1 stride-2 projection fed from the block input
                specs.append(ConvSpec(f"{tag}_proj", hw, hw, c, width,
                                      r=1, s=1, stride=2, relu=False,
                                      inp_from=block_in))
                skip = lid()
                specs.append(ConvSpec(f"{tag}_conv1", hw, hw, c, width,
                                      stride=2, relu=True,
                                      inp_from=block_in))
                hw, c = hw // 2, width
            else:
                skip = block_in
                specs.append(ConvSpec(f"{tag}_conv1", hw, hw, c, width,
                                      relu=True))
            specs.append(ConvSpec(f"{tag}_conv2", hw, hw, width, width,
                                  relu=False))
            specs.append(EltwiseSpec(f"{tag}_add", hw, hw, width,
                                     skip_from=skip, relu=True))
    specs.append(FCSpec("fc", hw * hw * c, n_classes, relu=False))
    return specs


def replay_stash(specs, params, x_nhwc: torch.Tensor) -> dict:
    """One fp32 forward pass with plain ops (``backend="torch"``), keeping
    every intermediate: ``{-1: input, i: output of spec i}``. ``params`` is
    the ``api.random_params`` layout, one ``(w, b)`` tensor pair per
    parameterized layer in spec order."""
    stash = {-1: x_nhwc.to(torch.float32)}
    pi = 0
    for i, spec in enumerate(specs):
        if isinstance(spec, ConvSpec):
            src = -1 if spec.inp_from == -1 else (
                spec.inp_from if spec.inp_from is not None else i - 1)
            w, b = params[pi]
            pi += 1
            y = hybrid_conv2d(stash[src], w, b, mode="spat",
                              stride=spec.stride, padding=spec.padding,
                              relu=spec.relu)
        elif isinstance(spec, PoolSpec):
            y = max_pool2d(stash[i - 1], spec.window, spec.stride)
        elif isinstance(spec, EltwiseSpec):
            y = stash[i - 1] + stash[spec.skip_from]
            if spec.relu:
                y = torch.relu(y)
        elif isinstance(spec, DepthwiseSpec):
            w, b = params[pi]
            pi += 1
            y = depthwise_conv2d(stash[i - 1], w, b, stride=spec.stride,
                                 padding=spec.padding, relu=spec.relu)
        elif isinstance(spec, FCSpec):
            w, b = params[pi]
            pi += 1
            x = stash[i - 1]
            if x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            y = dense(x, w, b, relu=spec.relu)
        else:
            raise TypeError(f"unknown spec kind {type(spec).__name__}")
        stash[i] = y
    return stash


def reference_forward(params, x_nhwc: torch.Tensor, specs) -> torch.Tensor:
    """Replay a spec chain with plain ops — no Program, no runtime: the
    oracle for any topology the compiler accepts."""
    with torch.no_grad():
        return replay_stash(specs, params, x_nhwc)[len(specs) - 1]
