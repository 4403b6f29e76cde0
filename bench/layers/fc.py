"""``fc``: the port's ``FCSpec``. Keys d_in, d_out and relu. FLOPs are 2 x
d_in x d_out; bytes its input, output, weights and bias, each once."""
from bench.yardstick.work import FLOAT_BYTES


def spec():
    from repro_torch.core.hybrid_conv import FCSpec
    return FCSpec


def out_hw(layer: dict) -> tuple[int, int]:
    return 1, 1


def flops(layer: dict, batch: int) -> int:
    return 2 * layer["d_in"] * layer["d_out"] * batch


def bytes(layer: dict, batch: int) -> int:
    acts = batch * (layer["d_in"] + layer["d_out"])
    params = layer["d_in"] * layer["d_out"] + layer["d_out"]
    return FLOAT_BYTES * (acts + params)
