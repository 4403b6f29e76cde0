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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (  # noqa: F401 (params_from_numpy)
    Params,
    _init,
    _tree_map,
    attention,
    init_attention,
    init_moe,
    init_swiglu,
    moe,
    params_from_numpy,
    remat_wrap,
    rms_norm,
    swiglu,
)


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


def apply_layer(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: dict, *,
                positions=None, kv_cache=None, cache_pos=None,
                image_embeds=None, causal: bool = True,
                backend: str = "torch"):
    h, new_cache = attention(
        p["attn"], rms_norm(x, p["norm"], cfg.norm_eps), cfg,
        positions=positions, causal=causal, kv_cache=kv_cache,
        cache_pos=cache_pos, backend=backend)
    x = x + h
    if kind["cross"] and image_embeds is not None:
        xh, _ = attention(
            p["xattn"], rms_norm(x, p["norm3"], cfg.norm_eps), cfg,
            xattn_kv=image_embeds, causal=False, use_rope=False,
            backend=backend)
        x = x + torch.tanh(p["xattn_gate"]) * xh
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind["moe"]:
        return x + moe(p["moe"], h2, cfg), new_cache
    return x + swiglu(p["ffn"], h2), new_cache


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


def _groups(params: Params, cfg: ModelConfig):
    """(group index, [layer params of each period slot]) as views."""
    period = len(params["layers"])
    for g in range(cfg.n_layers // period):
        yield g, [_tree_map(lambda t: t[g], params["layers"][i])
                  for i in range(period)]


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            image_embeds=None, positions=None,
            backend: str = "torch") -> torch.Tensor:
    """Training/prefill forward without a cache: (B, S) -> logits
    (B, S, V). Under autograd each group runs under ``remat_wrap`` (as the
    reference's scanned group body), so with ``cfg.remat`` the backward
    holds one group's activations at a time."""
    kinds = _layer_kinds(cfg)

    def group_body(x, group):
        for i, p in enumerate(group):
            x, _ = apply_layer(p, x, cfg, kinds[i], positions=positions,
                               image_embeds=image_embeds, backend=backend)
        return x

    if torch.is_grad_enabled():
        group_body = remat_wrap(group_body, cfg)
    # F.embedding, not indexing: its backward accumulates each row in one
    # fixed order (an indexing backward's accumulating index_put_ sums in
    # thread order on the CPU, so two runs would differ in the last bits)
    x = F.embedding(tokens.long(), params["embed"])
    for _, group in _groups(params, cfg):
        x = group_body(x, group)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# KV-cache serving path
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Per period-slot stacked cache: list of dicts with (G, B, S, KV, hd)."""
    period = group_period(cfg)
    n_groups = cfg.n_layers // period
    shape = (n_groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
            for _ in range(period)]


def decode_step(params: Params, token: torch.Tensor, cache, pos: int,
                cfg: ModelConfig, *, image_embeds=None,
                backend: str = "torch"):
    """One token for every sequence: token (B, 1) integers at position
    ``pos``. Returns (logits (B, V), cache), the cache updated in place.
    The same path serves prefill: token (B, S_prompt) with pos=0
    (causality is cache-relative)."""
    kinds = _layer_kinds(cfg)
    pos = int(pos)
    s = token.shape[1]
    x = params["embed"][token.long()]
    positions = pos + torch.arange(s, device=x.device)[None, :]
    for g, group in _groups(params, cfg):
        for i, p in enumerate(group):
            layer_cache = {"k": cache[i]["k"][g], "v": cache[i]["v"][g]}
            x, _ = apply_layer(p, x, cfg, kinds[i], positions=positions,
                               kv_cache=layer_cache, cache_pos=pos,
                               image_embeds=image_embeds, backend=backend)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1] @ params["lm_head"], cache


def prefill(params: Params, tokens: torch.Tensor, cache, cfg: ModelConfig, *,
            image_embeds=None, backend: str = "torch"):
    """Fill the KV cache from a prompt; returns (last-token logits, cache)."""
    return decode_step(params, tokens, cache, 0, cfg,
                       image_embeds=image_embeds, backend=backend)
