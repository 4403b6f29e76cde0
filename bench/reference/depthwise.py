"""A depthwise convolution in plain PyTorch: one (r, s) filter per channel,
HWIO weights (r, s, 1, c), padded as a conv (``bench/reference/conv.py``)."""
from bench.reference.conv import conv


def weight_shape(layer: dict):
    r, s = layer["r"], layer["s"]
    return (r, s, 1, layer["c"]), r * s


def forward(layer: dict, x, params, skip, cast):
    return conv(layer, x, params, cast, groups=layer["c"])
