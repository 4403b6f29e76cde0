"""Decoder-only transformer LM, dense, MoE and VLM families (port of the
reference's ``models/transformer.py``).

The parameter tree is the reference's: ``embed``, ``final_norm``,
``lm_head`` and ``layers``, a list (one entry per layer of a group) of
trees whose leaves are stacked ``(n_groups, ...)``. The reference's scan
over groups becomes a Python loop over views of those leaves. KV caches are
``(n_groups, B, Smax, KV, hd)`` per period slot and are written in place
(the reference donates them). A VLM's cross layers (every
``cross_attn_every``-th layer of a group) attend to ``image_embeds`` (the
stub frontend's patch embeddings) through ``xattn``, gated by
``tanh(xattn_gate)``, and are skipped when no image is given. An MoE
model's every ``moe_every``-th layer of a group runs ``layers.moe`` in
place of the SwiGLU FFN (llama4-scout: every layer, 16 experts;
llama4-maverick: alternating, 128 experts).

Tensor parallelism (ROADMAP 11i):
:func:`forward` and :func:`decode_step` run over a list of ``model``
positions, each with its plain tree of tensors; an unplaced tree is the
one position. Over parameters placed by ``train.steps.place`` on a mesh
whose ``model`` axis spans several positions, each position computes
whole heads: query heads ``[i H / n, (i + 1) H / n)`` and the KV heads
they read, with their ``wq``/``wk``/``wv`` columns and ``wo`` rows
(gathered from the shards they overlap where the heads do not divide the
positions), of the self-attention and of a VLM's cross-attention alike
(a position whose query heads straddle KV groups indexes its K and V to
one KV head per query head);
hidden units ``[i F / n, (i + 1) F / n)`` of the SwiGLU and of an MoE
layer's shared expert; and whole experts ``[i E / n, (i + 1) E / n)`` of
an MoE layer (expert parallelism: ``layers.moe`` over that range, routed
from the whole router, whose columns every position reads, so each token
takes the expert the unsplit model gives it; a position may hold none).
The norms, the cross-attention gate and the residual adds run replicated
on every position; one ``all_reduce_sum`` follows each row-split product
(``wo``, ``w_down``, the routed and shared experts' sum). The embedding
is split along ``d``: each position takes its columns of the rows, then
an ``all_gather``. The head is split along the vocabulary: the local
logits are gathered on the first position, or (``forward(shares=True)``,
the training path) kept where they lie for the cross-entropy over the
shares. A split model's KV cache (``layers.SplitCache``) holds, per
data row and position, the position's self-attention KV heads for the
row's share of the batch; a mesh of several data rows splits the batch,
and a VLM's image embeddings with it, over them in row order. The shares,
the attention and SwiGLU builders and sublayers are ``models/layers.py``'s,
which the SSM, hybrid and audio families share.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (  # noqa: F401 (params_from_numpy)
    Params,
    _init,
    _tp_ranges,
    _tree_map,
    at_positions,
    attention,
    decode_rows,
    embed_positions,
    head_logits,
    init_attention,
    init_moe,
    init_swiglu,
    layer_at,
    moe,
    params_from_numpy,
    position_trees,
    remat_wrap,
    residual_attention,
    residual_swiglu,
    rms_norm,
    straddle_offset,
    take_attention,
    take_swiglu,
)
from repro_torch.parallel import sharding


# ---------------------------------------------------------------------------
# layer-group structure
# ---------------------------------------------------------------------------

def group_period(cfg: ModelConfig) -> int:
    """Layers per group (lcm of the MoE and cross-attn periods)."""
    p = 1
    if cfg.n_experts and cfg.moe_every > 1:
        p = math.lcm(p, cfg.moe_every)
    if cfg.cross_attn_every:
        p = math.lcm(p, cfg.cross_attn_every)
    return p


def _layer_kinds(cfg: ModelConfig) -> list[dict]:
    """Description of each layer within one group."""
    kinds = []
    for layer_no in range(group_period(cfg)):
        is_moe = bool(cfg.n_experts) and (layer_no % cfg.moe_every
                                          == cfg.moe_every - 1)
        is_cross = bool(cfg.cross_attn_every) and (
            layer_no % cfg.cross_attn_every == cfg.cross_attn_every - 1)
        kinds.append({"moe": is_moe, "cross": is_cross})
    return kinds


def init_layer(gen: torch.Generator, cfg: ModelConfig, kind: dict, dtype,
               device) -> Params:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)
    p = {
        "norm": ones(),
        "attn": init_attention(gen, cfg, dtype, device),
        "norm2": ones(),
    }
    if kind["moe"]:
        p["moe"] = init_moe(gen, cfg, dtype, device)
    else:
        p["ffn"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device)
    if kind["cross"]:
        p["xattn"] = init_attention(gen, cfg, dtype, device)
        p["norm3"] = ones()
        p["xattn_gate"] = torch.zeros((1,), dtype=dtype, device=device)
    return p


def apply_layer(ps: list, xs: list, cfg: ModelConfig, kind: dict, *,
                positions: list, caches=None, cache_pos=None,
                image_embeds=None, backend: str = "torch") -> list:
    """One layer over the ``model`` positions (module doc): ``ps``, ``xs``,
    ``positions`` and ``caches`` hold each position's layer tree,
    activations (replicated), RoPE positions (or None) and layer cache.
    Each position's attention, cross-attention and FFN (or its experts
    and shared-expert share) give its partial sum of their row-split
    products; ``all_reduce_sum`` joins them (one position's is its
    own)."""
    xs = residual_attention(ps, xs, cfg, positions=positions, caches=caches,
                            cache_pos=cache_pos, backend=backend)
    if kind["cross"] and image_embeds is not None:
        xhs = [torch.zeros_like(x) if p["xattn"] is None else attention(
            p["xattn"], rms_norm(x, p["norm3"], cfg.norm_eps), cfg,
            xattn_kv=image_embeds.to(x.device), causal=False,
            use_rope=False, q_offset=straddle_offset(cfg, len(ps), i),
            backend=backend)[0] for i, (p, x) in enumerate(zip(ps, xs))]
        xs = [x + torch.tanh(p["xattn_gate"]) * xh
              for p, x, xh in zip(ps, xs, sharding.all_reduce_sum(xhs))]
    if not kind["moe"]:
        return residual_swiglu(ps, xs, cfg)
    fs = [moe(p["moe"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg,
              experts=_tp_ranges(cfg, len(ps), i)["experts"])
          for i, (p, x) in enumerate(zip(ps, xs))]
    return [x + f for x, f in zip(xs, sharding.all_reduce_sum(fs))]


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters at the reference's scales, drawn from
    ``generator`` on ``device`` (which must be the generator's). Each
    group's layer is drawn, then copied into the stacked leaves, so the
    peak is the model plus one layer; a model of one group keeps its
    layers as drawn (the stacked leaves are views of them)."""
    dtype = cfg.torch_dtype
    kinds = _layer_kinds(cfg)
    period = len(kinds)
    n_groups = cfg.n_layers // period
    assert n_groups * period == cfg.n_layers, \
        f"n_layers {cfg.n_layers} not divisible by group period {period}"

    layers: list = [None] * period
    for g in range(n_groups):
        for i in range(period):
            layer = init_layer(generator, cfg, kinds[i], dtype, device)
            if n_groups == 1:
                layers[i] = _tree_map(lambda t: t[None], layer)
                continue
            if layers[i] is None:
                layers[i] = _tree_map(
                    lambda t: t.new_empty((n_groups, *t.shape)), layer)
            _tree_map(lambda dst, src: dst[g].copy_(src), layers[i], layer)
            del layer
    return {
        "embed": _init(generator, (cfg.vocab_size, cfg.d_model), scale=1.0,
                       dtype=dtype, device=device),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": _init(generator, (cfg.d_model, cfg.vocab_size),
                         dtype=dtype, device=device),
    }


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            image_embeds=None, positions=None, backend: str = "torch",
            shares: bool = False):
    """Training/prefill forward without a cache: (B, S) -> logits
    (B, S, V), on the first position's device (with ``shares``, each
    position's (B, S, V_i) on its own, ``layers.head_logits``). Under
    autograd each group runs under ``remat_wrap`` (as the reference's
    scanned group body), so with ``cfg.remat`` the backward holds one
    group's activations at a time."""
    kinds = _layer_kinds(cfg)
    trees = position_trees(params, cfg, _position_tree)
    where = [None if positions is None else positions.to(t["embed"].device)
             for t in trees]

    def group_body(xs, groups):
        for i, kind in enumerate(kinds):
            xs = apply_layer([g[i] for g in groups], xs, cfg, kind,
                             positions=where, image_embeds=image_embeds,
                             backend=backend)
        return xs

    if torch.is_grad_enabled():
        group_body = remat_wrap(group_body, cfg)
    xs = embed_positions(trees, tokens)
    for g in range(cfg.n_layers // len(kinds)):
        xs = group_body(xs, [[layer_at(slot, g) for slot in t["layers"]]
                             for t in trees])
    return head_logits(trees, xs, cfg, shares=shares)


# ---------------------------------------------------------------------------
# KV-cache serving path
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                  share: dict | None = None):
    """Per period-slot stacked cache: list of dicts with (G, B, S, KV, hd);
    a model position's ``share`` (``_tp_ranges``) holds its KV heads."""
    period = group_period(cfg)
    n_groups = cfg.n_layers // period
    k0, k1 = share["kv_heads"] if share else (0, cfg.n_kv_heads)
    shape = (n_groups, batch, max_len, k1 - k0, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
            for _ in range(period)]


def decode_step(params: Params, token: torch.Tensor, cache, pos,
                cfg: ModelConfig, *, image_embeds=None,
                backend: str = "torch"):
    """One token for every sequence: token (B, 1) integers at position
    ``pos``, a host int or a 0-d integer tensor on the device (read
    there: the step the card captures, ``train.steps.DecodeStep``).
    Returns (logits (B, V), cache), the cache updated in place. The same
    path serves prefill: token (B, S_prompt) with pos=0 (causality is
    cache-relative). Placed parameters decode into a
    :class:`SplitCache`, each data row its share of the batch (and of
    ``image_embeds``); the logits are on the mesh's first device."""
    kinds = _layer_kinds(cfg)

    def row(params, token, caches, image_embeds):
        trees = position_trees(params, cfg, _position_tree)
        s = token.shape[1]
        where = [at_positions(pos, s, t["embed"].device)[None, :]
                 for t in trees]
        xs = embed_positions(trees, token)
        for g in range(cfg.n_layers // len(kinds)):
            for slot, kind in enumerate(kinds):
                xs = apply_layer(
                    [layer_at(t["layers"][slot], g) for t in trees], xs, cfg,
                    kind, positions=where, caches=[
                        {"k": c[slot]["k"][g], "v": c[slot]["v"][g]}
                        for c in caches], cache_pos=pos,
                    image_embeds=image_embeds, backend=backend)
        return head_logits(trees, [x[:, -1] for x in xs], cfg)

    return decode_rows(params, token, cache, row, image_embeds=image_embeds)


def prefill(params: Params, tokens: torch.Tensor, cache, cfg: ModelConfig, *,
            image_embeds=None, backend: str = "torch"):
    """Fill the KV cache from a prompt; returns (last-token logits, cache)."""
    return decode_step(params, tokens, cache, 0, cfg,
                       image_embeds=image_embeds, backend=backend)


# ---------------------------------------------------------------------------
# tensor parallelism along ``model`` (module doc)
# ---------------------------------------------------------------------------

def _position_tree(params: Params, cfg: ModelConfig, i: int) -> Params:
    """The plain tree position ``i`` computes with (``_tp_ranges``): its
    own shards where its share is its shard, else the columns, rows or
    experts assembled from the shards the share overlaps (or cut from the
    master copy of a leaf the placement could not split). An MoE layer
    reads the whole router."""
    r = _tp_ranges(cfg, params["embed"].n, i)
    e0, e1 = r["experts"]

    def experts(m):
        out = {"router": m["router"].take(-1, 0, cfg.n_experts, i)}
        for name in ("we_gate", "we_up", "we_down"):
            out[name] = m[name].take(-3, e0, e1, i)
        if "shared" in m:
            out["shared"] = take_swiglu(m["shared"], r, i)
        return out

    def layer(lp):
        out = {"norm": lp["norm"].at(i),
               "attn": take_attention(lp["attn"], cfg, r, i),
               "norm2": lp["norm2"].at(i)}
        if "moe" in lp:
            out["moe"] = experts(lp["moe"])
        else:
            out["ffn"] = take_swiglu(lp["ffn"], r, i)
        if "xattn" in lp:
            out.update(xattn=take_attention(lp["xattn"], cfg, r, i),
                       norm3=lp["norm3"].at(i),
                       xattn_gate=lp["xattn_gate"].at(i))
        return out

    return {"embed": params["embed"].take(-1, *r["embed"], i),
            "layers": [layer(lp) for lp in params["layers"]],
            "final_norm": params["final_norm"].at(i),
            "lm_head": params["lm_head"].take(-1, *r["vocab"], i)}
