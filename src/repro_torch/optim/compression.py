"""Error-feedback gradient compression for the data-parallel all-reduce
(port of the reference's ``optim/compression.py``).

int8 quantization with a per-tensor scale and an error-feedback
accumulator: the quantization residual is carried into the next step, so
the compressed optimizer converges (the compression error telescopes).
``compressed_psum`` compresses each replica's gradients, all-reduces the
int8 payload (as int32 sums) and decompresses the mean. The reference runs
it inside ``shard_map`` over its data axes; here each replica is a process
of a ``torch.distributed`` group. As in the reference, no training step
calls it. Its two all-reduces a tensor (the amax and the int32 payload)
reach the roofline's collective term (``launch/roofline.py``).

The scheme (``scale = (amax + 1e-12) / 127``, zero point 0, values clipped
to [-127, 127]) is also the repo's definition of "int8": the calibration
observers of ``repro_torch.quant`` reuse ``quantize_int8``. On numpy input
it runs in numpy float32 with the reference's arithmetic step for step, so
the ``minmax`` observer's scales match it bit for bit; on a tensor it runs
the same float32 arithmetic in torch on the tensor's device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.launch import roofline


def quantize_int8(x):
    """Per-tensor symmetric int8: returns ``(q, scale)`` (a tensor and a
    0-dim float32 tensor for tensor input; arrays otherwise)."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.float32)
        scale = _over_127(x.abs().max() + 1e-12)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale
    x = np.asarray(x, np.float32)
    amax = np.float32(np.abs(x).max()) + np.float32(1e-12)
    scale = np.float32(amax / np.float32(127.0))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def _over_127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` as a true division on every device (CUDA multiplies
    by the reciprocal of a Python scalar divisor)."""
    return amax / torch.full_like(amax, 127.0)


def dequantize_int8(q, scale):
    if isinstance(q, torch.Tensor):
        return q.to(torch.float32) * scale
    return np.asarray(q).astype(np.float32) * np.float32(scale)


def compress_grad(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compress: returns ``(q, scale, new_err)``."""
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale)
    return q, scale, new_err


def init_error_state(grads):
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)


def compressed_psum(grads, err_state, group=None):
    """Compress, all-reduce as int8 payloads, mean-decompress; one call per
    replica of ``group`` (default: the whole ``torch.distributed`` world).

    The quantization scale must be agreed by every replica before the
    integer all-reduce (``sum_i q_i * s`` decodes; per-replica scales do
    not): one all-reduce of the amax (MAX) sets it. Error feedback is taken
    against the common-scale decoding, which keeps the telescoping
    invariant per replica. Returns ``(mean_grads, new_err_state)``.
    """
    n = dist.get_world_size(group)

    def one(g, e):
        corrected = g.to(torch.float32) + e
        amax = corrected.abs().max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        roofline.declare_collective("all-reduce", amax.element_size())
        scale = _over_127(amax + 1e-12)
        q = torch.clamp(torch.round(corrected / scale), -127, 127)
        q = q.to(torch.int8)
        new_e = corrected - q.to(torch.float32) * scale
        # int8 payloads sum without overflow in int32
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        roofline.declare_collective(
            "all-reduce", summed.numel() * summed.element_size())
        mean = summed.to(torch.float32) * scale / n
        return mean.to(g.dtype), new_e

    pairs = pytree.tree_map(one, grads, err_state)
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
    return (pytree.tree_map(lambda t: t[0], pairs, is_leaf=is_pair),
            pytree.tree_map(lambda t: t[1], pairs, is_leaf=is_pair))
