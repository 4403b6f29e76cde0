"""A convolution in plain PyTorch: NHWC in and out, HWIO weights, through
NCHW. ``padding`` is ``"SAME"`` (TensorFlow's rule), ``"VALID"`` or
``[[top, bottom], [left, right]]``."""
import torch.nn.functional as F

from bench.reference.net import same_pads


def pads(layer: dict) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) of a conv or depthwise entry."""
    padding = layer["padding"]
    if padding == "SAME":
        return (same_pads(layer["h"], layer["r"], layer["stride"]),
                same_pads(layer["w"], layer["s"], layer["stride"]))
    if padding == "VALID":
        return (0, 0), (0, 0)
    if isinstance(padding, str):
        raise ValueError(f"{layer['name']}: unknown padding {padding!r}")
    (top, bottom), (left, right) = padding
    return (top, bottom), (left, right)


def weight_shape(layer: dict):
    r, s, c = layer["r"], layer["s"], layer["c"]
    return (r, s, c, layer["k"]), r * s * c


def conv(layer: dict, x, params, cast, groups: int = 1):
    w, b = params
    (pt, pb), (pl, pr) = pads(layer)
    xin = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    return F.conv2d(cast(xin), cast(w.permute(3, 2, 0, 1)), b,
                    stride=layer["stride"], groups=groups
                    ).permute(0, 2, 3, 1)


def forward(layer: dict, x, params, skip, cast):
    return conv(layer, x, params, cast)
