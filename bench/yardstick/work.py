"""The work a network asks for, counted from its layer table alone.

Each entry's FLOPs, bytes and output size come from its kind's file,
``bench/layers/<kind>.py``, found by name. A layer's FLOPs are 2 x the
multiply-accumulates of its product; pooling and adds count none. A
Winograd plan is counted as the same work as a spatial one, so a faster
algorithm shows as a higher share of the bound, not as less work. A
layer's bytes are its inputs, weights, bias and output, each once, in
float32; weights once per batch. Its bound is the larger of FLOPs over the
TF32 peak and bytes over the HBM bandwidth, and a network's bound is the
sum over its layers."""
from __future__ import annotations

from bench.layers import find
from bench.yardstick import peaks

FLOAT_BYTES = 4


def out_hw(layer: dict) -> tuple[int, int]:
    """Output height and width of an entry."""
    return find(layer["kind"]).out_hw(layer)


def layer_flops(layer: dict, batch: int) -> int:
    return find(layer["kind"]).flops(layer, batch)


def layer_bytes(layer: dict, batch: int) -> int:
    return find(layer["kind"]).bytes(layer, batch)


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
