"""The work a network asks for, counted from its layer table alone.

A layer's FLOPs are 2 x the multiply-accumulates of the direct convolution
or of the fully-connected product; pooling counts none.
A Winograd plan is counted as the same work as a spatial one, so a faster
algorithm shows as a higher share of the bound, not as less work. A
layer's bytes are its input, weights, bias and output, each once, in
float32; weights once per batch. Its bound is the larger of FLOPs over the
TF32 peak and bytes over the HBM bandwidth, and a network's bound is the
sum over its layers.

Layer table entries (``kind``): ``conv`` (h, w, c, k, r, s, stride,
padding "SAME"), ``pool`` (h, w, c, window, stride; VALID), ``fc`` (d_in,
d_out)."""
from __future__ import annotations

from bench.yardstick import peaks

FLOAT_BYTES = 4


def out_hw(layer: dict) -> tuple[int, int]:
    """Output height and width of a conv or pool layer."""
    h, w, stride = layer["h"], layer["w"], layer.get("stride", 1)
    if layer["kind"] == "pool":
        win = layer["window"]
        return (h - win) // stride + 1, (w - win) // stride + 1
    if layer.get("padding", "SAME") != "SAME":
        raise ValueError(f"{layer['name']}: only SAME padding is counted")
    return -(-h // stride), -(-w // stride)


def layer_flops(layer: dict, batch: int) -> int:
    kind = layer["kind"]
    if kind == "conv":
        ho, wo = out_hw(layer)
        macs = layer["k"] * layer["c"] * layer["r"] * layer["s"] * ho * wo
        return 2 * macs * batch
    if kind == "fc":
        return 2 * layer["d_in"] * layer["d_out"] * batch
    if kind == "pool":
        return 0
    raise ValueError(f"unknown layer kind {kind!r}")


def layer_bytes(layer: dict, batch: int) -> int:
    kind = layer["kind"]
    if kind == "conv":
        ho, wo = out_hw(layer)
        acts = batch * (layer["h"] * layer["w"] * layer["c"]
                        + ho * wo * layer["k"])
        params = layer["r"] * layer["s"] * layer["c"] * layer["k"] \
            + layer["k"]
        return FLOAT_BYTES * (acts + params)
    if kind == "fc":
        acts = batch * (layer["d_in"] + layer["d_out"])
        params = layer["d_in"] * layer["d_out"] + layer["d_out"]
        return FLOAT_BYTES * (acts + params)
    if kind == "pool":
        ho, wo = out_hw(layer)
        return FLOAT_BYTES * batch * layer["c"] * (layer["h"] * layer["w"]
                                                   + ho * wo)
    raise ValueError(f"unknown layer kind {kind!r}")


def flops_per_image(layers: list[dict]) -> int:
    return sum(layer_flops(layer, 1) for layer in layers)


def bound_s(layers: list[dict], batch: int) -> float:
    """The least time one H100 could take for a batch: per layer the larger
    of its compute and its memory time, summed over the layers."""
    return sum(max(layer_flops(layer, batch) / peaks.TF32_FLOPS,
                   layer_bytes(layer, batch) / peaks.HBM_BYTES)
               for layer in layers)


def bound_terms_s(layers: list[dict], batch: int) -> tuple[float, float]:
    """The network's compute time and memory time at the peaks, each summed
    over every layer (each alone is below :func:`bound_s`)."""
    return (sum(layer_flops(layer, batch) for layer in layers)
            / peaks.TF32_FLOPS,
            sum(layer_bytes(layer, batch) for layer in layers)
            / peaks.HBM_BYTES)



def roofline_share(run) -> float | None:
    """Percent: the counted bound of the batches whose kernels the traced
    slice holds whole, at the bucket each ran, over those kernels' time."""
    tr = run.trace
    if tr is None or not tr["buckets"] or not tr["kernel_s"]:
        return None
    bound = sum(bound_s(run.layers, b) for b in tr["buckets"])
    return 100.0 * bound / tr["kernel_s"]
