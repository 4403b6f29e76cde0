"""``conv``: the port's ``ConvSpec``. Keys h, w, c, k, r, s, stride,
padding (``"SAME"``, ``"VALID"`` or ``[[top, bottom], [left, right]]``) and
relu. FLOPs are 2 x the direct convolution's multiply-accumulates; bytes
its input, output, weights and bias, each once."""
from bench.reference.conv import pads
from bench.yardstick.work import FLOAT_BYTES


def spec():
    from repro_torch.core.hybrid_conv import ConvSpec
    return ConvSpec


def out_hw(layer: dict) -> tuple[int, int]:
    (pt, pb), (pl, pr) = pads(layer)
    stride = layer["stride"]
    return ((layer["h"] + pt + pb - layer["r"]) // stride + 1,
            (layer["w"] + pl + pr - layer["s"]) // stride + 1)


def flops(layer: dict, batch: int) -> int:
    ho, wo = out_hw(layer)
    macs = layer["k"] * layer["c"] * layer["r"] * layer["s"] * ho * wo
    return 2 * macs * batch


def bytes(layer: dict, batch: int) -> int:
    ho, wo = out_hw(layer)
    acts = batch * (layer["h"] * layer["w"] * layer["c"]
                    + ho * wo * layer["k"])
    params = layer["r"] * layer["s"] * layer["c"] * layer["k"] + layer["k"]
    return FLOAT_BYTES * (acts + params)
