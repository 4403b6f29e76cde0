"""A max pool in plain PyTorch, NHWC in and out; ``pad`` (default 0) pads
each side with -inf, as ``F.max_pool2d``'s ``padding`` does."""
import torch.nn.functional as F


def weight_shape(layer: dict):
    return None


def forward(layer: dict, x, params, skip, cast):
    return F.max_pool2d(x.permute(0, 3, 1, 2), layer["window"],
                        layer["stride"], padding=layer.get("pad", 0)
                        ).permute(0, 2, 3, 1)
