"""Post-training int8 quantization, ported from ``repro.quant``:

* ``observers`` / ``calibrate`` — replay the spec chain in fp32 over
  sample activations and record per-layer ranges (min/max or percentile);
* ``sidecar`` — the versioned ``QuantSidecar`` (``hybriddnn-quant/v1``)
  carried beside the ``Program``, readable by either package;
* ``execute`` — the int8 PE dispatch: int8 inputs and weights, exact int32
  accumulation, fused requantize(+ReLU) epilogue, through K5 on
  ``backend="hopper"``.

Scheme: per-tensor symmetric activations, per-output-channel weights, zero
point 0, ``scale = amax / 127``, values clipped to [-127, 127].
"""
from repro_torch.quant.calibrate import calibrate
from repro_torch.quant.execute import (
    qconv2d,
    qdense,
    qdepthwise,
    qeltwise,
    quantize_params,
    quantize_tensor,
    requantize,
)
from repro_torch.quant.observers import (
    MinMaxObserver,
    PercentileObserver,
    make_observer,
)
from repro_torch.quant.sidecar import FORMAT, LayerQuant, QuantSidecar

__all__ = [
    "FORMAT", "LayerQuant", "QuantSidecar",
    "MinMaxObserver", "PercentileObserver", "make_observer",
    "calibrate",
    "qconv2d", "qdense", "qdepthwise", "qeltwise",
    "quantize_params", "quantize_tensor", "requantize",
]
