"""``add``: the port's ``EltwiseSpec``, a residual add of the map the entry
reads and the map its ``skip`` names. Keys h, w, c and relu. It counts no
FLOPs, as pooling does; its bytes are two operands and one output."""
from bench.yardstick.work import FLOAT_BYTES


def spec():
    from repro_torch.core.hybrid_conv import EltwiseSpec
    return EltwiseSpec


def out_hw(layer: dict) -> tuple[int, int]:
    return layer["h"], layer["w"]


def flops(layer: dict, batch: int) -> int:
    return 0


def bytes(layer: dict, batch: int) -> int:
    return FLOAT_BYTES * batch * 3 * layer["h"] * layer["w"] * layer["c"]
