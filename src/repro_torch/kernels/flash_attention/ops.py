"""Public wrapper of K6 in the reference's layout: ``(B, H, S, D)`` with GQA.

The reference's wrapper (``src/repro/kernels/flash_attention/ops.py``)
repeats K and V per query head, pads Sq and Skv to its TPU block sizes and
crops the output. Here the kernel's tiles are fixed for Hopper (128 query
rows by 64 KV rows per step in bf16, 64 by 64 in fp32, sized to the SM's
registers and shared memory), it masks the ragged edges itself, and it
maps query heads to KV heads in place, so the wrapper only flattens
``(B, H)`` into one axis and back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, row_offset: int = 0) -> torch.Tensor:
    """q (B, H, Sq, D), k and v (B, Hkv, Skv, D) -> (B, H, Sq, D).

    ``causal`` masks with the top-left alignment of the reference kernel,
    shifted by ``row_offset``: query row ``i`` sees key columns
    ``<= i + row_offset`` (0, the default, is the reference kernel's mask;
    a chunk whose first position is ``p`` in the cache takes ``p``)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or GQA heads")
    o = flash_attention_kernel(q.reshape(b * h, sq, d).contiguous(),
                               k.reshape(b * hkv, skv, d).contiguous(),
                               v.reshape(b * hkv, skv, d).contiguous(),
                               causal=causal, row_offset=row_offset)
    return o.reshape(b, h, sq, d)
