"""Weights and images of a cell, made from ``--seed`` on the device in a few
large calls. The program and the reference each get them from here: the
reference draws them again after the program's state is freed, and the
same seed on the same device gives the same numbers."""
from __future__ import annotations

import numpy as np
import torch

from bench.layers import find

POOL = 256      # images a cell's requests draw from
BIAS_SCALE = 0.1


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 2 + stream) % 2 ** 63)
    return g


def weight_shapes(layers: list[dict]) -> list[tuple[tuple, int]]:
    """(shape, fan_in) of each weight, in layer order: the entries whose
    kind's reference (``bench/reference/<kind>.py``) has one."""
    shapes = (find(layer["kind"], "reference").weight_shape(layer)
              for layer in layers)
    return [shape for shape in shapes if shape is not None]


def make_weights(layers: list[dict], seed: int, device) -> list:
    """[(w, b), ...] of every layer with a weight, float32: weights normal with
    the variance 2 / fan_in (He et al., arXiv:1502.01852), which keeps each
    layer's outputs of the order of 1 through the ReLUs, and biases normal
    times ``BIAS_SCALE``, a tenth of that order."""
    shapes = weight_shapes(layers)
    sizes = [int(np.prod(shape)) for shape, _ in shapes]
    g = _generator(seed, 0, device)
    flat = torch.randn(sum(sizes), generator=g, device=device,
                       dtype=torch.float32)
    biases = torch.randn(sum(shape[-1] for shape, _ in shapes), generator=g,
                         device=device, dtype=torch.float32).mul_(BIAS_SCALE)
    params, at, bat = [], 0, 0
    for (shape, fan_in), n in zip(shapes, sizes):
        w = flat[at:at + n].view(shape).mul_((2.0 / fan_in) ** 0.5)
        b = biases[bat:bat + shape[-1]]
        params.append((w, b))
        at, bat = at + n, bat + shape[-1]
    return params


def make_images(config: dict, seed: int, device) -> np.ndarray:
    """The pool of images, (POOL, H, W, C) float32 on the host."""
    hw, c = config["input_resolution"], config["channels"]
    x = torch.randn((POOL, hw, hw, c), generator=_generator(seed, 1, device),
                    device=device, dtype=torch.float32)
    return x.cpu().numpy()
