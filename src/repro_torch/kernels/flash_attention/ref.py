"""The plain PyTorch version of K6 (flash attention), over ``(BH, S, D)``.

It computes what the reference's Pallas body ``_fa_kernel``
(``src/repro/kernels/flash_attention/kernel.py``) computes, in one pass
instead of blocks: fp32 scores times ``scale``, the causal mask aligned at
the TOP LEFT (query row ``i`` sees key columns ``j <= i``; with
``row_offset`` the columns ``j <= i + row_offset``, as the reference's
scan-flash masks a chunk whose first position is ``row_offset``), columns
at or past ``kv_len`` masked, ``-1e30`` as the masked value, an fp32
softmax and P V product, and the output cast to ``q.dtype``.

It differs on purpose from the reference's oracle ``attention_ref``
(``kernels/flash_attention/ref.py``), whose causal mask is aligned at the
bottom right (``tril(k=Skv - Sq)``): the two agree only when Sq == Skv.
The LM prefill attends a prompt of Sq tokens to a cache of Skv > Sq
positions from row 0, which is the top-left mask the kernel has.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None,
                        kv_len: int | None = None,
                        row_offset: int = 0) -> torch.Tensor:
    """(BH, Sq, D) x (BHkv, Skv, D) -> (BH, Sq, D); BHkv divides BH and
    query head ``i`` reads KV head ``i // (BH // BHkv)`` (GQA)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kv_len = skv if kv_len is None else kv_len
    group = bh // k.shape[0]
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    cols = torch.arange(skv, device=q.device)
    valid = (cols < kv_len)[None, :]
    if causal:
        rows = row_offset + torch.arange(sq, device=q.device)
        valid = valid & (cols[None, :] <= rows[:, None])
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
