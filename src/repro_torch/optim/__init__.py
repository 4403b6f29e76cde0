"""Optimizer-side numerics. Only the int8 scheme of ``compression`` is
ported so far: the post-training calibration observers of
``repro_torch.quant`` share its definition of "int8"."""
from repro_torch.optim.compression import dequantize_int8, quantize_int8

__all__ = ["dequantize_int8", "quantize_int8"]
