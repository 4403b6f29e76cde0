"""Transformer building blocks of the LM side (port of the reference's
``models/layers.py``), as functions over plain dicts of tensors.

RMSNorm, RoPE, GQA attention with an optional KV cache and cross-attention
(K/V from encoder or image states), the scan-flash attention, SwiGLU and
the GELU MLP, with the reference's bf16 rounding points. The reference's
``shard(...)`` constraints are dropped: these functions compute on plain
tensors, and under tensor parallelism (``models/transformer.py``) each
``model`` position calls them on its own shard of the weights.
``attention`` reads its head counts from its weights' shapes, so on a
position's heads it returns that position's partial sum of ``out @ wo``;
``swiglu`` on a position's hidden units returns its partial sum of the
row-split ``w_down`` product. At 2048 query tokens and more, attention
takes the reference's long-sequence branch, where ``backend`` picks the
implementation: ``"torch"`` runs the port of ``_flash_attention_scan``,
``"hopper"`` runs K6 (``kernels/flash_attention``) with the causal mask
shifted by the chunk's row offset, as the scan's (a cross-attention is
never causal). Below 2048
both backends run the reference's einsum branch, which is no Pallas
kernel. K6 has no backward (nor has the reference's kernel): under
autograd its wrapper raises, and training runs the scan. ``remat_wrap`` is
the reference's activation checkpointing. The MoE FFN (``init_moe``,
``moe``, ``moe_ref``) is the reference's top-1 token-choice routing with a
per-row capacity and an optional shared expert; its router stays float32
in every model dtype.

Tensor parallelism along the mesh's ``model`` axis (ROADMAP 11i) shares
its parts across the families here: each position's share of heads,
hidden units, SSM heads, experts, embedding columns and vocabulary
(``_tp_ranges``); the builders of a position's attention, SwiGLU and GELU
MLP trees from placed leaves (``take_attention``, ``take_swiglu``,
``take_mlp``); the residual attention and SwiGLU sublayers over a list of
positions, one ``all_reduce_sum`` after each row-split product
(``residual_attention``, ``residual_swiglu``); the embedding over the
positions (``embed_positions``); and the split cache (:class:`SplitCache`)
with the data-row loop that decodes into it (``decode_rows``). An
unplaced tree is the one position, so the unsplit path is the same code.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.compat import resolve_backend, to_tensor
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.parallel import sharding

Params = dict[str, Any]

NEG_INF = -1e30
LONG_SEQ = 2048   # the reference's threshold for the scan-flash branch
# leaves the reference keeps in float32 whatever the model's dtype: the
# SSM's log-decay, skip weight and step bias (``models/mamba2.py``) and
# the MoE router
FP32_LEAVES = frozenset({"A_log", "D", "dt_bias", "router"})


# the matmuls without batch dimensions (``x @ W`` reaches aten as ``mm``):
# what the reference's ``dots_with_no_batch_dims_saveable`` policy saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, cfg: ModelConfig):
    """Activation checkpointing with the config's remat policy (the
    reference's ``jax.checkpoint``): ``fn`` runs under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps
    only its inputs and recomputes its body in the backward ("none"), or
    also keeps the outputs of its matmuls without batch dimensions
    ("dots"). No RNG state is stashed for the recompute
    (``preserve_rng_state=False``): no model draws random numbers, and a
    CUDA generator's state cannot be read while a train step is captured
    (``steps.TrainStep``)."""
    if not cfg.remat:
        return fn
    kw = {"preserve_rng_state": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def _tree_map(fn, *trees):
    """``fn`` over the leaves of matching dict/list trees of tensors (None
    kept: a position's empty attention tree)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {key: _tree_map(fn, *(t[key] for t in trees)) for key in t0}
    if isinstance(t0, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def stack_layers(make, n: int):
    """Draw ``n`` layers with ``make()`` and copy each into leaves stacked
    ``(n, ...)``, so the peak is the stack plus one layer."""
    out = None
    for i in range(n):
        layer = make()
        if out is None:
            out = _tree_map(lambda t: t.new_empty((n, *t.shape)), layer)
        _tree_map(lambda dst, src: dst[i].copy_(src), out, layer)
        del layer
    return out


def layer_at(tree, *idx):
    """The views ``leaf[idx]`` of a stacked layer tree."""
    return _tree_map(lambda t: t[idx], tree)


def params_from_numpy(tree, cfg: ModelConfig, device) -> Params:
    """The reference's parameter tree of any LM family, with float32 numpy
    leaves (cast bf16 JAX arrays to float32 before ``np.asarray``) -> the
    same tree of tensors on ``device``: in ``cfg.torch_dtype``, but the
    leaves named in ``FP32_LEAVES``, which stay float32 as the
    reference's."""
    dtype, device = cfg.torch_dtype, torch.device(device)

    def carry(t, name):
        if isinstance(t, dict):
            return {k: carry(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [carry(v, name) for v in t]
        a = np.asarray(t)
        if a.dtype != np.float32:
            raise TypeError(f"params_from_numpy takes float32 leaves, got "
                            f"{a.dtype}")
        return to_tensor(a, device,
                         torch.float32 if name in FP32_LEAVES else dtype)
    return carry(tree, None)


def _init(gen: torch.Generator, shape, *, scale=None, dtype=torch.float32,
          device) -> torch.Tensor:
    """Normal draws times ``scale`` (default fan-in ``shape[0] ** -0.5``)
    in float32, then cast, as the reference's ``_init``."""
    scale = scale if scale is not None else (shape[0] ** -0.5 if shape
                                             else 1.0)
    x = torch.randn(shape, generator=gen, device=device)
    return x.mul_(scale).to(dtype)   # in place: one float32 temporary


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """fp32 variance reduction, normalize-multiply in ``x.dtype``."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: (..., S) integers."""
    d = x.shape[-1]
    half = d // 2
    # log(theta) / half in fp32 as the reference takes it; a Python float
    # of that value, so nothing is copied to the device (a host-to-device
    # copy synchronises the stream, once per call)
    step = float(torch.log(torch.tensor(theta, dtype=torch.float32)) / half)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device) * step)
    ang = positions[..., None].float() * freqs             # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm / KV cache)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _init(gen, (d, h * hd), dtype=dtype, device=device),
        "wk": _init(gen, (d, kv * hd), dtype=dtype, device=device),
        "wv": _init(gen, (d, kv * hd), dtype=dtype, device=device),
        "wo": _init(gen, (h * hd, d), dtype=dtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def at_positions(pos, s: int, device) -> torch.Tensor:
    """The positions ``pos .. pos + s - 1`` as int64 on ``device``:
    ``pos`` a host int, or a 0-d integer tensor (the captured decode's,
    read on the device: the reference's traced ``pos``)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device) + torch.arange(s, device=device)
    return torch.arange(pos, pos + s, device=device)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions=None, causal: bool = True, kv_cache=None,
              cache_pos: int | torch.Tensor | None = None, xattn_kv=None,
              use_rope: bool = True, q_offset: int | None = None,
              backend: str = "torch"):
    """Attention of x (B, S, D) to itself, or with ``xattn_kv`` (B, Skv, D)
    (encoder or image states) to those: a cross-attention takes its K/V
    from them, applies no RoPE and masks nothing.

    kv_cache: optional dict(k=(B, Smax, KV, hd), v=...). With ``cache_pos``
    the new K/V are written into it IN PLACE at that position (the
    reference donates the cache, so nothing else reads the old one) and
    the queries attend to the whole cache; without, the cache is being
    built and the result carries this call's K/V. Returns (out, cache).
    ``cache_pos`` is a host int or a 0-d integer tensor: the K/V go in by
    ``index_copy_`` at ``cache_pos + arange(s)`` (the reference's
    ``dynamic_update_slice_in_dim``) and the causal mask's row offset is
    read on the device, so a decode step reads no position on the host
    and can be captured. The long-sequence branches (s >= ``LONG_SEQ``)
    need a host int: a tensor ``cache_pos`` there raises ``TypeError``;
    an int past the cache's end raises ``ValueError``.

    The query heads of ``p`` read its KV heads in equal blocks of
    ``H // KV``, unless ``q_offset`` is given: a model position's query
    heads that straddle KV groups (``_tp_ranges``' ``q_offset``, the
    place of its first query head in its first KV group). Then K and V
    (after the cache, which keeps the position's KV heads) are indexed
    to one KV head per query head, and the rest runs with one query head
    a KV head.
    """
    backend = resolve_backend(backend)
    b, s, _ = x.shape
    if isinstance(cache_pos, torch.Tensor) and s >= LONG_SEQ:
        raise TypeError(f"attention: {s} queries take the long-sequence "
                        f"branch, which needs cache_pos as a host int, "
                        f"not a tensor")
    if (kv_cache is not None and cache_pos is not None
            and not isinstance(cache_pos, torch.Tensor)
            and cache_pos + s > kv_cache["k"].shape[1]):
        raise ValueError(f"attention: positions up to {cache_pos + s} "
                         f"exceed the cache's {kv_cache['k'].shape[1]}")
    # the heads these weights hold: all of them, or a model position's
    hd = cfg.head_dim
    h, kv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd

    q = (x @ p["wq"]).reshape(b, s, h, hd)
    kv_src = xattn_kv if xattn_kv is not None else x
    skv = kv_src.shape[1]
    k = (kv_src @ p["wk"]).reshape(b, skv, kv, hd)
    v = (kv_src @ p["wv"]).reshape(b, skv, kv, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if use_rope and xattn_kv is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        if cache_pos is not None:   # decode: insert new K/V at position
            at = at_positions(cache_pos, s, k.device)
            kv_cache["k"].index_copy_(1, at, k.to(kv_cache["k"].dtype))
            kv_cache["v"].index_copy_(1, at, v.to(kv_cache["v"].dtype))
            new_cache = kv_cache
            k, v = kv_cache["k"], kv_cache["v"]
            skv = k.shape[1]
        else:                        # prefill: cache is being built
            new_cache = {"k": k, "v": v}

    if q_offset is not None:        # a share that straddles KV groups
        group = cfg.n_heads // cfg.n_kv_heads
        pair = (q_offset + torch.arange(h, device=k.device)) // group
        k, v, kv = k.index_select(2, pair), v.index_select(2, pair), h

    # GQA via grouped einsum: never materialize a repeated KV tensor
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, hd)

    row_offset = (cache_pos if (kv_cache is not None and cache_pos is not None)
                  else (skv - s if causal else 0))
    masked = causal and xattn_kv is None
    if s >= LONG_SEQ and backend == "hopper":
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=masked,
                              row_offset=row_offset if masked else 0)
        out = out.transpose(1, 2)                     # (B, S, H, hd)
    elif s >= LONG_SEQ:
        out = _flash_attention_scan(qg, k, v, causal=masked,
                                    row_offset=row_offset)
    else:
        scale = hd ** -0.5
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() * scale
        if masked:
            rows_abs = at_positions(row_offset, s, x.device)[
                None, None, None, :, None]
            col = torch.arange(skv, device=x.device)[None, None, None, None, :]
            logits = torch.where(col <= rows_abs, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    out = out.reshape(b, s, h * hd) @ p["wo"]
    return out, new_cache


def _flash_attention_scan(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, row_offset: int = 0,
                          block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block`` (grouped GQA).

    qg: (B, S, KV, R, D) grouped queries; k/v: (B, Skv, KV, D). The
    reference's ``lax.scan`` becomes a loop; P is rounded to the query
    dtype before the P V product, as there. Memory is O(S * block) per
    head.
    """
    b, s, kv, r, d = qg.shape
    skv = k.shape[1]
    scale = d ** -0.5
    nb = -(-skv // block)
    pad = nb * block - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kb = k.reshape(b, nb, block, kv, d)
    vb = v.reshape(b, nb, block, kv, d)
    rows = row_offset + torch.arange(s, device=qg.device)[
        None, None, None, :, None]

    m_prev = torch.full((b, kv, r, s, 1), NEG_INF, device=qg.device)
    l_prev = torch.zeros((b, kv, r, s, 1), device=qg.device)
    acc = torch.zeros((b, kv, r, s, d), device=qg.device)
    for bi in range(nb):
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qg, kb[:, bi]).float() * scale
        cols = bi * block + torch.arange(block, device=qg.device)[
            None, None, None, None, :]
        valid = cols < skv
        if causal:
            valid = valid & (cols <= rows)
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m_prev, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m_prev - m_new)
        l_prev = alpha * l_prev + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(qg.dtype), vb[:, bi]).float()
        m_prev = m_new
    out = (acc / l_prev).permute(0, 3, 1, 2, 4)   # (B, S, KV, R, D)
    return out.to(qg.dtype)


# ---------------------------------------------------------------------------
# FFN: SwiGLU (llama-family) and GELU-MLP (whisper)
# ---------------------------------------------------------------------------

def init_swiglu(gen: torch.Generator, d: int, f: int, dtype,
                device) -> Params:
    return {
        "w_gate": _init(gen, (d, f), dtype=dtype, device=device),
        "w_up": _init(gen, (d, f), dtype=dtype, device=device),
        "w_down": _init(gen, (f, d), dtype=dtype, device=device),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]


def init_mlp(gen: torch.Generator, d: int, f: int, dtype, device) -> Params:
    return {"w_in": _init(gen, (d, f), dtype=dtype, device=device),
            "w_out": _init(gen, (f, d), dtype=dtype, device=device),
            "b_in": torch.zeros((f,), dtype=dtype, device=device),
            "b_out": torch.zeros((d,), dtype=dtype, device=device)}


def mlp(p: Params, x: torch.Tensor, out_bias: bool = True) -> torch.Tensor:
    """The reference's ``jax.nn.gelu`` defaults to the tanh approximation,
    so this is ``approximate="tanh"``, not the exact erf GELU. Without
    ``out_bias`` the product's partial sum over a position's hidden units,
    to which ``b_out`` is added once after the all-reduce."""
    h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
    out = h @ p["w_out"]
    return out + p["b_out"] if out_bias else out


# ---------------------------------------------------------------------------
# MoE: top-1 token-choice routing with capacity + optional shared expert
# (llama4-style), the reference's sort-based dispatch
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": _init(gen, (d, e), scale=d ** -0.5, dtype=torch.float32,
                        device=device),
        "we_gate": _init(gen, (e, d, f), scale=d ** -0.5, dtype=dtype,
                         device=device),
        "we_up": _init(gen, (e, d, f), scale=d ** -0.5, dtype=dtype,
                       device=device),
        "we_down": _init(gen, (e, f, d), scale=f ** -0.5, dtype=dtype,
                         device=device),
    }
    if cfg.shared_expert:
        p["shared"] = init_swiglu(gen, d, f, dtype, device)
    return p


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t`` (B, N, D) at the rows ``idx`` (B, M) of each batch row ->
    (B, M, D): the reference's ``take_along_axis`` as one
    ``index_select`` over the flattened rows, so no (B, M, D) index
    exists."""
    b, n, d = t.shape
    flat = idx + torch.arange(b, device=idx.device)[:, None] * n
    return t.reshape(b * n, d).index_select(0, flat.reshape(-1)).reshape(
        b, -1, d)


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
        experts: tuple[int, int] | None = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Top-1 routing on the float32 router
    logits (the first maximum, as ``jnp.argmax``), a softmax gate, and a
    per-row capacity ``cap``: each expert's bucket takes its tokens in
    their original order (a stable sort) and drops those past ``cap``.
    Every expert's SwiGLU runs on its whole (B, cap, D) bucket.

    ``experts`` is the range ``[e0, e1)`` of experts ``p["we_*"]`` hold
    (default: all of them; ``p["router"]`` is always the whole router).
    Routing, capacity and dispatch are computed over all experts; only the
    range's buckets run, and a token reads its slot only where it lies in
    the range, scaled by its gate (every other token reads zero), plus the
    shared expert of whatever hidden units ``p["shared"]`` holds. The
    outputs of disjoint ranges covering every expert, each with its share
    of the shared expert's hidden units, sum to the whole call's."""
    b, s, d = x.shape
    e = cfg.n_experts
    e0, e1 = experts or (0, e)

    if e1 > e0:
        gate_logits = x.float() @ p["router"]                   # (B, S, E)
        expert_idx = gate_logits.argmax(-1)                      # (B, S)
        gate = torch.softmax(gate_logits, -1)
        gate_val = gate.gather(-1, expert_idx[..., None])[..., 0]  # (B, S)

        cap = max(1, int(cfg.capacity_factor * s / e) + 1)
        onehot = F.one_hot(expert_idx, e)                        # (B, S, E)
        pos_all = onehot.cumsum(1) - 1
        pos = pos_all.gather(-1, expert_idx[..., None])[..., 0]  # (B, S)
        keep = pos < cap
        dest = torch.where(keep, expert_idx * cap + pos, e * cap)  # (B, S)

        # bucket fill via stable sort: tokens grouped by expert, original
        # order; only the range's slots [lo, hi) are gathered
        lo, hi = e0 * cap, e1 * cap
        counts = onehot.sum(1)                                   # (B, E)
        starts = counts.cumsum(1) - counts                       # exclusive
        sort_idx = torch.argsort(expert_idx, dim=1, stable=True)  # (B, S)
        cidx = torch.arange(cap, device=x.device)
        src = starts[:, :, None] + cidx                          # (B, E, cap)
        valid = cidx < counts.clamp(max=cap)[:, :, None]
        src = src.clamp(0, s - 1).reshape(b, e * cap)[:, lo:hi]
        tok_idx = sort_idx.gather(1, src)                        # (B, hi-lo)
        buckets = _rows(x, tok_idx) * valid.reshape(b, e * cap, 1)[
            :, lo:hi].to(x.dtype)
        buckets = buckets.reshape(b, e1 - e0, cap, d)

        g = torch.einsum("becd,edf->becf", buckets, p["we_gate"])
        u = torch.einsum("becd,edf->becf", buckets, p["we_up"])
        y = torch.einsum("becf,efd->becd", F.silu(g) * u, p["we_down"])
        y = y.reshape(b, hi - lo, d)

        # combine: token s reads its slot (a clipped sentinel or a slot
        # outside the range -> masked)
        out = _rows(y, (dest - lo).clamp(0, hi - lo - 1))
        out = out * (keep & (dest >= lo) & (dest < hi))[..., None]
        out = out * gate_val[..., None].to(x.dtype)
    else:                       # a model position that holds no expert
        out = torch.zeros_like(x)
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    return out


def moe_ref(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: dense per-expert loop, no capacity drops."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gate_logits = xf.float() @ p["router"]
    idx = gate_logits.argmax(-1)
    gate = torch.softmax(gate_logits, -1)
    gval = gate.gather(-1, idx[:, None])[:, 0]
    out = torch.zeros_like(xf)
    for ei in range(cfg.n_experts):
        m = (idx == ei)[:, None]
        g = xf @ p["we_gate"][ei]
        u = xf @ p["we_up"][ei]
        y = (F.silu(g) * u) @ p["we_down"][ei]
        out = out + torch.where(m, y, 0.0)
    out = out * gval[:, None].to(x.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], xf[None])[0]
    return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
# tensor parallelism along ``model`` (module doc): shares, position trees,
# the sublayers over the positions, the split cache
# ---------------------------------------------------------------------------

def _tp_ranges(cfg: ModelConfig, n: int, i: int) -> dict:
    """Position ``i``'s share of ``n``: query heads, the KV heads they read,
    hidden units, experts, SSM heads, embedding columns and vocabulary, as
    [start, stop), ``[i T / n, (i + 1) T / n)`` of each total ``T``. A share
    may be uneven or empty: 40 query heads over 16 positions give 2 or 3
    a position, 8 give every other position none (its KV share is empty
    too), as do fewer experts or SSM heads than positions. A share of
    query heads that lies inside one KV group, or starts and ends on group
    boundaries, reads its KV heads in equal blocks; one that straddles KV
    groups (48 query heads over 8 KV heads on 6 positions: position 0's
    heads [0, 8) read KV head 0 six times and KV head 1 twice) has
    ``q_offset``, its first head's place ``h0 % rep`` in its first group,
    by which ``attention`` pairs each query head with its KV head (None
    for every other share). A config without attention (mamba2) has no
    head shares."""
    share = lambda total: (i * total // n, (i + 1) * total // n)  # noqa
    out = {"ffn": share(cfg.d_ff), "experts": share(cfg.n_experts),
           "ssm_heads": share(cfg.n_ssm_heads),
           "embed": share(cfg.d_model), "vocab": share(cfg.vocab_size)}
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if not h:
        return out
    rep = h // kv
    h0, h1 = share(h)
    if h0 == h1:
        return {**out, "heads": (h0, h0), "kv_heads": (h0 // rep, h0 // rep),
                "q_offset": None}
    k0, k1 = h0 // rep, (h1 - 1) // rep + 1
    straddles = k1 - k0 > 1 and bool(h0 % rep or h1 % rep)
    return {**out, "heads": (h0, h1), "kv_heads": (k0, k1),
            "q_offset": h0 % rep if straddles else None}


def straddle_offset(cfg: ModelConfig, n: int, i: int) -> int | None:
    """``attention``'s ``q_offset`` for position ``i`` of ``n`` (None
    unless its query heads straddle KV groups)."""
    return _tp_ranges(cfg, n, i).get("q_offset")


def position_trees(params: Params, cfg: ModelConfig, build) -> list:
    """Each ``model`` position's plain tree, ``build(params, cfg, i)``, over
    placed ``params``; an unplaced tree is the one position's."""
    if not sharding.is_split(params):
        return [params]
    return [build(params, cfg, i) for i in range(params["embed"].n)]


def take_attention(a: Params, cfg: ModelConfig, r: dict, i: int):
    """Position ``i``'s attention tree (share ``r``): its query heads'
    ``wq`` columns and ``wo`` rows, the KV heads they read, gathered from
    the shards they overlap where the heads do not divide the positions;
    None where the share holds no head."""
    hd = cfg.head_dim
    (h0, h1), (k0, k1) = r["heads"], r["kv_heads"]
    if h0 == h1:
        return None
    out = {"wq": a["wq"].take(-1, h0 * hd, h1 * hd, i),
           "wk": a["wk"].take(-1, k0 * hd, k1 * hd, i),
           "wv": a["wv"].take(-1, k0 * hd, k1 * hd, i),
           "wo": a["wo"].take(-2, h0 * hd, h1 * hd, i)}
    for name in ("q_norm", "k_norm"):
        if name in a:
            out[name] = a[name].at(i)
    return out


def take_swiglu(f: Params, r: dict, i: int) -> Params:
    """Position ``i``'s hidden units of a SwiGLU."""
    f0, f1 = r["ffn"]
    return {"w_gate": f["w_gate"].take(-1, f0, f1, i),
            "w_up": f["w_up"].take(-1, f0, f1, i),
            "w_down": f["w_down"].take(-2, f0, f1, i)}


def take_mlp(f: Params, r: dict, i: int) -> Params:
    """Position ``i``'s hidden units of a GELU MLP, and the master copy of
    ``b_out`` (added once, after the all-reduce)."""
    f0, f1 = r["ffn"]
    return {"w_in": f["w_in"].take(-1, f0, f1, i),
            "b_in": f["b_in"].take(-1, f0, f1, i),
            "w_out": f["w_out"].take(-2, f0, f1, i),
            "b_out": f["b_out"].at(i)}


def embed_positions(trees: list, tokens: torch.Tensor) -> list:
    """The token rows: each position's columns of them, all-gathered along
    d. F.embedding, not indexing: its backward accumulates each row in one
    fixed order (an indexing backward's accumulating index_put_ sums in
    thread order on the CPU, so two runs would differ in the last bits)."""
    tokens = tokens.long()
    return sharding.all_gather(
        [F.embedding(tokens.to(t["embed"].device), t["embed"])
         for t in trees], -1)


def head_logits(trees: list, xs: list, cfg: ModelConfig, *,
                shares: bool = False):
    """The final norm and the head over the positions' vocabulary shares,
    gathered on the first position; with ``shares``, the list of shares,
    each on its position's device (the training path's: the loss reads
    them where they lie, ``train.steps.cross_entropy``)."""
    parts = [rms_norm(x, t["final_norm"], cfg.norm_eps) @ t["lm_head"]
             for x, t in zip(xs, trees)]
    return parts if shares else sharding.gather_parts(parts, -1)


def residual_attention(ps: list, xs: list, cfg: ModelConfig, *,
                       attn: str = "attn", norm: str = "norm",
                       positions=None, caches=None, cache_pos=None,
                       xattn_kv=None, causal: bool = True,
                       use_rope: bool = True,
                       backend: str = "torch") -> list:
    """``x + attention(rms_norm(x))`` over the ``model`` positions: each
    position's layer tree ``ps[i][attn]`` (its heads) gives its partial sum
    of the ``wo`` product, ``all_reduce_sum`` joins them. ``positions``
    and ``caches`` hold each position's RoPE positions and KV cache (or
    None); a cross-attention's ``xattn_kv`` is read on every position.
    A position that holds no head (``ps[i][attn]`` None) runs no attention
    and hands zeros of the residual's shape to the all-reduce; one whose
    heads straddle KV groups pairs them by its ``q_offset``."""
    n = len(ps)
    positions = positions or [None] * n
    caches = caches or [None] * n
    hs = [torch.zeros_like(x) if p[attn] is None else attention(
        p[attn], rms_norm(x, p[norm], cfg.norm_eps), cfg, positions=pos,
        kv_cache=c, cache_pos=cache_pos,
        xattn_kv=None if xattn_kv is None else xattn_kv.to(x.device),
        causal=causal, use_rope=use_rope, q_offset=straddle_offset(cfg, n, i),
        backend=backend)[0]
        for i, (p, x, pos, c) in enumerate(zip(ps, xs, positions, caches))]
    return [x + h for x, h in zip(xs, sharding.all_reduce_sum(hs))]


def residual_swiglu(ps: list, xs: list, cfg: ModelConfig) -> list:
    """``x + swiglu(rms_norm(x, norm2))`` over the positions, each on its
    hidden units of ``ffn``, the ``w_down`` partial sums all-reduced."""
    fs = [swiglu(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps))
          for p, x in zip(ps, xs)]
    return [x + f for x, f in zip(xs, sharding.all_reduce_sum(fs))]


class SplitCache:
    """The serving cache of a split model: ``rows[r][i]``, data row ``r``'s
    cache on ``model`` position ``i``, the family's own layout
    (``make(batch, device, share)``) with the row's ``batch / rows``
    sequences and the position's share (``_tp_ranges``: its KV heads, SSM
    heads and conv channels), on that position's device, written in
    place. ``placement`` is a ``NamedSharding`` over the mesh
    (``train.steps.init_cache``)."""

    def __init__(self, cfg: ModelConfig, batch: int, placement, make):
        rows = placement.n_rows
        if batch % rows:
            raise ValueError(f"a batch of {batch} rows does not split "
                             f"evenly over {rows} data rows")
        n = placement.positions
        shares = [_tp_ranges(cfg, n, i) for i in range(n)]
        self.rows = [[make(batch // rows, dev, share) for dev, share in
                      zip(placement.row_devices(r), shares)]
                     for r in range(rows)]


def decode_rows(params: Params, token: torch.Tensor, cache, step,
                **per_row):
    """A decode step over the data rows: ``step(params_r, token_r, caches,
    **per_row_r)`` for each row ``r`` (``caches``: each position's cache,
    ``per_row_r`` the row's share of each batch-major tensor in
    ``per_row``, None kept) -> (last-token logits (B, V) on the first
    row's device, cache). Placed parameters decode into a
    :class:`SplitCache`, unplaced ones into their family's plain cache
    (one row of one position)."""
    split = isinstance(cache, SplitCache)
    if split != sharding.is_split(params):
        raise TypeError("placed parameters decode into a SplitCache and "
                        "unplaced ones into a plain cache: build it with "
                        "train.steps.init_cache under the mesh's use_rules")
    rows = cache.rows if split else [[cache]]
    b = token.shape[0]
    if b % len(rows):
        raise ValueError(f"a batch of {b} rows does not split evenly over "
                         f"{len(rows)} data rows")
    per = b // len(rows)
    cut = lambda t, r: None if t is None else t[r * per:(r + 1) * per]  # noqa
    out = [step(params if r == 0 else sharding.row(params, r),
                cut(token, r), caches,
                **{k: cut(v, r) for k, v in per_row.items()})
           for r, caches in enumerate(rows)]
    if len(out) == 1:
        return out[0], cache
    return torch.cat([o.to(out[0].device) for o in out]), cache
