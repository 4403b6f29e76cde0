"""A network of the benchmark's layer tables in plain PyTorch, float32.

The walker over a layer table: each entry runs as its kind's
``forward`` (``bench/reference/<kind>.py``, found by name) on NHWC maps,
with TensorFloat-32 off in cuBLAS and cuDNN and cuDNN itself off, so every
product is a plain float32 GEMM. An entry reads the map its ``from`` names
(an earlier entry's ``name``, or ``"input"``), by default the one before
it, and an ``add`` its ``skip`` besides; a map is kept only while a later
entry still reads it. An entry with ``relu`` true is followed by a ReLU.
``SAME`` padding follows TensorFlow's rule (``total = (ceil(h / stride) -
1) * stride + r - h``, the smaller half on top and left), which is
asymmetric for stride 2.

``tf32=True`` is the control: every product's operands (the kinds'
``cast``) rounded to TensorFloat-32 (10 mantissa bits, to nearest even)
before the float32 product, which is what the tensor cores' TF32 mode
does to its inputs.
This file and its kinds import nothing of the program."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from bench.layers import INPUT, find


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


def _reads(layers: list[dict]) -> list[list[str]]:
    """The maps each entry reads: its ``from`` (by default the entry before
    it), then its ``skip`` if it has one; a name of no earlier entry is
    refused."""
    seen, prev, out = {INPUT}, INPUT, []
    for layer in layers:
        names = [layer.get("from", prev)] + (
            [layer["skip"]] if "skip" in layer else [])
        for key, name in zip(("from", "skip"), names):
            if name not in seen:
                raise ValueError(f"layer {layer['name']!r}: {key!r} names "
                                 f"{name!r}, no earlier layer")
        out.append(names)
        prev = layer["name"]
        seen.add(prev)
    return out


def forward(layers: list[dict], weights: list, x: torch.Tensor, *,
            tf32: bool = False) -> torch.Tensor:
    """Logits (n, classes) of NHWC images ``x``; ``weights`` is one (w, b)
    per entry whose kind has a weight (``weight_shape``), in layer order."""
    cast = round_tf32 if tf32 else (lambda t: t)
    params = iter(weights)
    reads = _reads(layers)
    last = {name: i for i, names in enumerate(reads) for name in names}
    maps = {INPUT: x}
    with plain_float32(), torch.no_grad():
        for i, (layer, names) in enumerate(zip(layers, reads)):
            kind = find(layer["kind"], "reference")
            y = kind.forward(
                layer, maps[names[0]],
                next(params) if kind.weight_shape(layer) else None,
                maps[names[1]] if len(names) > 1 else None, cast)
            if layer.get("relu", False):
                y = torch.relu(y)
            y = y.contiguous()
            for name in names:
                if last[name] == i:
                    maps.pop(name, None)
            if layer["name"] in last:
                maps[layer["name"]] = y
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
