"""A network of the benchmark's layer tables in plain PyTorch, float32.

Convolutions, max pools and fully-connected layers, in sequence, run as
``torch.nn.functional`` operations on NHWC maps (each conv through NCHW),
with TensorFloat-32 off in cuBLAS and cuDNN and cuDNN itself off, so every
product is a plain float32 GEMM. ``SAME`` padding follows TensorFlow's
rule (``total = (ceil(h / stride) - 1) * stride + r - h``, the smaller half
on top and left), which is asymmetric for stride 2. FC layers read the
NHWC map flattened in (h, w, c) order.

``tf32=True`` is the control: every conv's and FC's operands rounded to
TensorFloat-32 (10 mantissa bits, to nearest even) before the float32
product, which is what the tensor cores' TF32 mode does to its inputs.
This file imports nothing of the program."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest TF32 value (ties to even)."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & -0x2000).view(torch.float32)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def plain_float32():
    """cuBLAS and cuDNN in IEEE float32 (no TF32), cuDNN off."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def forward(layers: list[dict], weights: list, x: torch.Tensor, *,
            tf32: bool = False) -> torch.Tensor:
    """Logits (n, classes) of NHWC images ``x``; ``weights`` is one (w, b)
    per conv (HWIO) and FC ((d_in, d_out)) layer, in layer order."""
    cast = round_tf32 if tf32 else (lambda t: t)
    params = iter(weights)
    y = x
    with plain_float32(), torch.no_grad():
        for layer in layers:
            kind = layer["kind"]
            if kind == "conv":
                w, b = next(params)
                pt, pb = same_pads(layer["h"], layer["r"], layer["stride"])
                pl, pr = same_pads(layer["w"], layer["s"], layer["stride"])
                xin = F.pad(y.permute(0, 3, 1, 2), (pl, pr, pt, pb))
                y = F.conv2d(cast(xin), cast(w.permute(3, 2, 0, 1)), b,
                             stride=layer["stride"]).permute(0, 2, 3, 1)
            elif kind == "pool":
                y = F.max_pool2d(y.permute(0, 3, 1, 2), layer["window"],
                                 layer["stride"]).permute(0, 2, 3, 1)
            elif kind == "fc":
                w, b = next(params)
                y = cast(y.reshape(y.shape[0], -1)) @ cast(w) + b
            else:
                raise ValueError(f"unknown layer kind {kind!r}")
            if layer.get("relu", False):
                y = torch.relu(y)
            y = y.contiguous()
        return y


def logits(layers: list[dict], weights: list, images: np.ndarray, device, *,
           tf32: bool = False, block: int = 32) -> np.ndarray:
    """The reference's logits of every image, computed ``block`` images at
    a time so that it fits beside nothing else on the device."""
    out = []
    for at in range(0, len(images), block):
        x = torch.from_numpy(images[at:at + block]).to(device)
        out.append(forward(layers, weights, x, tf32=tf32).cpu().numpy())
    return np.concatenate(out) if out else np.empty((0, 0), np.float32)
