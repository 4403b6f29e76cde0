"""``pool``: the port's ``PoolSpec``, a max pool. Keys h, w, c, window,
stride and an optional pad (default 0) of -inf on each side. It counts no
FLOPs; its bytes are its input and output, each once."""
from bench.yardstick.work import FLOAT_BYTES


def spec():
    from repro_torch.core.hybrid_conv import PoolSpec
    return PoolSpec


def out_hw(layer: dict) -> tuple[int, int]:
    win, stride, pad = layer["window"], layer["stride"], layer.get("pad", 0)
    return ((layer["h"] + 2 * pad - win) // stride + 1,
            (layer["w"] + 2 * pad - win) // stride + 1)


def flops(layer: dict, batch: int) -> int:
    return 0


def bytes(layer: dict, batch: int) -> int:
    ho, wo = out_hw(layer)
    return FLOAT_BYTES * batch * layer["c"] * (layer["h"] * layer["w"]
                                               + ho * wo)
