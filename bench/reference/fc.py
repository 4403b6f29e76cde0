"""A fully-connected layer in plain PyTorch: the NHWC map flattened in
(h, w, c) order times a (d_in, d_out) weight."""


def weight_shape(layer: dict):
    return (layer["d_in"], layer["d_out"]), layer["d_in"]


def forward(layer: dict, x, params, skip, cast):
    w, b = params
    return cast(x.reshape(x.shape[0], -1)) @ cast(w) + b
