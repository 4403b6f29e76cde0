"""``depthwise``: the port's ``DepthwiseSpec``, one (r, s) filter per
channel. Keys h, w, c, r, s, stride, padding (as a ``conv``'s) and relu.
FLOPs are 2 x c x r x s x ho x wo; bytes its input, output, weights and
bias, each once."""
from bench.layers.conv import out_hw
from bench.yardstick.work import FLOAT_BYTES


def spec():
    from repro_torch.core.hybrid_conv import DepthwiseSpec
    return DepthwiseSpec


def flops(layer: dict, batch: int) -> int:
    ho, wo = out_hw(layer)
    return 2 * layer["c"] * layer["r"] * layer["s"] * ho * wo * batch


def bytes(layer: dict, batch: int) -> int:
    ho, wo = out_hw(layer)
    c = layer["c"]
    acts = batch * c * (layer["h"] * layer["w"] + ho * wo)
    return FLOAT_BYTES * (acts + layer["r"] * layer["s"] * c + c)
