"""Optimizer-side numerics: AdamW and int8 gradient compression.

``compression`` defines the repo's canonical per-tensor symmetric int8
scheme (``scale = amax / 127``, zero_point = 0, clip to [-127, 127]) —
for the error-feedback gradient all-reduce, and reused verbatim by
``repro_torch.quant``'s post-training calibration observers so training-time
and inference-time "int8" mean the same arithmetic.
"""
from repro_torch.optim.compression import (compress_grad, compressed_psum,
                                           dequantize_int8, init_error_state,
                                           quantize_int8)

__all__ = [
    "compress_grad", "compressed_psum", "dequantize_int8",
    "init_error_state", "quantize_int8",
]
