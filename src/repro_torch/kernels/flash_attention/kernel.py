"""K6 ``flash_attention``: online-softmax attention, hand-written for Hopper.

Replaces ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_kernel`` (body ``_fa_kernel``): ``(BH, Sq, D)`` queries
against ``(BH / group, Skv, D)`` keys and values, fp32 running statistics
and P, the causal mask aligned at the top left (shifted by ``row_offset``)
and the ``kv_len`` mask, fp32 or bf16 in and out, ``head_dim`` up to 128.
The CUDA kernel (``csrc/flash_attention.cu``) maps each query head to its
KV head itself (``bh // group``), so K and V are never repeated in memory,
and masks the ragged Sq and Skv edges itself, so nothing is padded. The
dtype picks its body: bf16 runs on the tensor cores (``wgmma``, P split
into three bf16 terms so that it stays fp32), fp32 on the FMA pipes (the
tensor cores would round it to TF32). Its note says what bounds each and
what the design does about that.
"""
from __future__ import annotations

import struct

import torch

from repro_torch.kernels.common import counted, launch, on_cpu
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

MAX_HEAD_DIM = 128


def _check(q, k, v, kv_len, row_offset):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention takes (BH, S, D) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, sq, d = q.shape
    bhkv, skv, dk = k.shape
    if v.shape != k.shape or dk != d:
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if bhkv == 0 or bh % bhkv:
        raise ValueError(f"flash_attention: {bhkv} KV heads do not divide "
                         f"{bh} query heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} is not in 1.."
                         f"{MAX_HEAD_DIM}; the kernel keeps a thread's "
                         f"share of a 64 x {MAX_HEAD_DIM} output block in "
                         f"registers")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not 1 <= kv_len <= skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} not in 1..{skv}")
    if row_offset < 0:
        raise ValueError(f"flash_attention: row_offset {row_offset} < 0 "
                         f"leaves rows with no unmasked column")


def attended_pairs(sq: int, kv_len: int, causal: bool,
                   row_offset: int) -> int:
    """Unmasked (query row, key column) pairs of one head: row ``i`` sees
    ``min(i + 1 + row_offset, kv_len)`` columns when causal, else
    ``kv_len``."""
    if not causal:
        return sq * kv_len
    a = row_offset + 1                     # columns row 0 sees, unclipped
    short = min(max(kv_len - a, 0), sq)    # rows below the kv_len clip
    return short * a + short * (short - 1) // 2 + (sq - short) * kv_len


def flash_attention_work(bh: int, bhkv: int, sq: int, skv: int, d: int, *,
                         causal: bool, kv_len: int, row_offset: int,
                         itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: 4 D FLOPs (Q K^T and P V, a
    multiply-add each) per unmasked pair of every query head; Q, K, V read
    once and O written once."""
    flops = 4.0 * d * attended_pairs(sq, kv_len, causal, row_offset) * bh
    nbytes = itemsize * (2.0 * bh * sq * d + 2.0 * bhkv * skv * d)
    return flops, nbytes


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           scale: float | None = None,
                           kv_len: int | None = None,
                           row_offset: int = 0) -> torch.Tensor:
    """(BH, Sq, D) x (BHkv, Skv, D) -> (BH, Sq, D) in ``q.dtype``.

    Query head ``i`` reads KV head ``i // (BH // BHkv)``. Columns at or past
    ``kv_len`` (default Skv) are masked; ``causal`` masks every column
    above the row shifted by ``row_offset`` (row ``i`` sees columns
    ``<= i + row_offset``; non-causal calls ignore it). ``scale`` defaults
    to ``D ** -0.5``.
    """
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    row_offset = int(row_offset)
    _check(q, k, v, kv_len, row_offset)
    bh, sq, d = q.shape
    bhkv, skv, _ = k.shape
    cpu = on_cpu("flash_attention", q, k, v, dtypes=q.dtype)
    with counted("flash_attention", flash_attention_work, bh, bhkv, sq,
                 skv, d, causal=causal, kv_len=kv_len,
                 row_offset=row_offset, itemsize=q.element_size(),
                 on=q.device):
        if cpu:
            return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                       kv_len=kv_len, row_offset=row_offset)
        return _launch(q, k, v, causal, scale, kv_len, row_offset)


def _launch(q, k, v, causal, scale, kv_len, row_offset):
    bh, sq, d = q.shape
    bhkv, skv, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    scale_bits = struct.unpack("<I", struct.pack("<f", scale))[0]
    out = torch.empty_like(q)
    if sq:
        launch("flash_attention", [q, k, v, out],
               [bh, bh // bhkv, sq, skv, d, kv_len, causal,
                q.dtype == torch.bfloat16, scale_bits, row_offset])
    return out
