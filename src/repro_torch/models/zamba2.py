"""Zamba2: a Mamba2 backbone and one *shared* attention block,
arXiv:2411.15242 (port of the reference's ``models/zamba2.py``).

One attention + SwiGLU block's parameters are reused after every group of
``shared_attn_every`` mamba layers; a remainder tail (n_layers %
shared_attn_every) runs without the shared block. The parameter tree is
the reference's: ``groups`` with leaves ``(n_groups, per, ...)``, an
optional ``tail`` ``(tail, ...)``, one ``shared`` block. Decode carries
both cache kinds, written in place: per-mamba-layer conv/SSM states and
one KV cache per application of the shared block. A prefill (more than
one token) starts every mamba layer from a zeroed state, as the
reference's ``* 0`` does; ``mamba2.decode_step`` carries its cache instead.

Tensor parallelism along ``model`` (ROADMAP 11i): the mamba layers of
``groups`` and ``tail`` split as ``mamba2``'s (whole SSM heads a
position), the shared block as a dense layer (its query and KV heads and
SwiGLU hidden units, ``layers.residual_attention`` and
``residual_swiglu``); every position's trees are built once a call, the
shared block's reused by all groups. A position's cache holds its conv
channels, SSM heads and KV heads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    Params,
    _init,
    _tp_ranges,
    at_positions,
    decode_rows,
    embed_positions,
    head_logits,
    init_attention,
    init_swiglu,
    layer_at,
    position_trees,
    remat_wrap,
    residual_attention,
    residual_swiglu,
    stack_layers,
    take_attention,
    take_swiglu,
)
from repro_torch.models.mamba2 import (
    conv_channels,
    init_mamba_block,
    mamba_block,
    mamba_block_cached,
    take_block,
)


def _geometry(cfg: ModelConfig) -> tuple[int, int, int]:
    per = cfg.shared_attn_every
    n_groups = cfg.n_layers // per
    tail = cfg.n_layers - n_groups * per
    return per, n_groups, tail


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters at the reference's scales, drawn from
    ``generator`` on ``device``."""
    dtype = cfg.torch_dtype
    per, n_groups, tail = _geometry(cfg)
    block = lambda: init_mamba_block(generator, cfg, dtype, device)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)
    p = {}
    if n_groups:
        p["groups"] = stack_layers(lambda: stack_layers(block, per), n_groups)
    if tail:
        p["tail"] = stack_layers(block, tail)
    p["shared"] = {
        "norm": ones(),
        "attn": init_attention(generator, cfg, dtype, device),
        "norm2": ones(),
        "ffn": init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }
    p["embed"] = _init(generator, (cfg.vocab_size, cfg.d_model), scale=1.0,
                       dtype=dtype, device=device)
    p["final_norm"] = ones()
    p["lm_head"] = _init(generator, (cfg.d_model, cfg.vocab_size),
                         dtype=dtype, device=device)
    return p


def _shared_block(shared: list, xs: list, cfg: ModelConfig, *,
                  positions=None, caches=None, cache_pos=None,
                  backend: str = "torch") -> list:
    """The shared attention + SwiGLU block over the ``model`` positions
    (each position's tree of it; ``positions`` and ``caches`` each
    position's RoPE positions and KV cache, or None)."""
    xs = residual_attention(shared, xs, cfg, positions=positions,
                            caches=caches, cache_pos=cache_pos,
                            backend=backend)
    return residual_swiglu(shared, xs, cfg)


def _position_tree(params: Params, cfg: ModelConfig, i: int) -> Params:
    r = _tp_ranges(cfg, params["embed"].n, i)
    s = params["shared"]
    out = {"embed": params["embed"].take(-1, *r["embed"], i),
           "shared": {"norm": s["norm"].at(i),
                      "attn": take_attention(s["attn"], cfg, r, i),
                      "norm2": s["norm2"].at(i),
                      "ffn": take_swiglu(s["ffn"], r, i)},
           "final_norm": params["final_norm"].at(i),
           "lm_head": params["lm_head"].take(-1, *r["vocab"], i)}
    for name in ("groups", "tail"):
        if name in params:
            out[name] = take_block(params[name], cfg, r, i)
    return out


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            backend: str = "torch", shares: bool = False):
    """(B, S) -> logits (B, S, V), without a cache, on the first
    position's device (with ``shares``, each position's vocabulary share
    on its own, ``layers.head_logits``). Under autograd each group (its
    mamba layers and the shared block) runs under ``remat_wrap``, as the
    reference's scanned group body; the tail runs unwrapped, as there."""
    per, n_groups, tail = _geometry(cfg)

    def group_body(xs, group_ps, shared):
        for i in range(per):
            xs, _ = mamba_block([layer_at(g, i) for g in group_ps], xs, cfg)
        return _shared_block(shared, xs, cfg, backend=backend)

    if torch.is_grad_enabled():
        group_body = remat_wrap(group_body, cfg)
    trees = position_trees(params, cfg, _position_tree)
    shared = [t["shared"] for t in trees]
    xs = embed_positions(trees, tokens)
    for g in range(n_groups):
        xs = group_body(xs, [layer_at(t["groups"], g) for t in trees],
                        shared)
    for i in range(tail):
        xs, _ = mamba_block([layer_at(t["tail"], i) for t in trees], xs, cfg)
    return head_logits(trees, xs, cfg, shares=shares)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               share: dict | None = None):
    """The decode cache (a model position's ``share``, ``_tp_ranges``:
    its conv channels, SSM heads and KV heads)."""
    per, n_groups, tail = _geometry(cfg)
    h, conv_dim = conv_channels(cfg, share)
    k0, k1 = share["kv_heads"] if share else (0, cfg.n_kv_heads)
    ssm = (h, cfg.ssm_state, cfg.ssm_head_dim)
    mk = lambda *shape: torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=device)
    f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                     device=device)
    cache = {
        "groups_conv": mk(n_groups, per, batch, cfg.ssm_conv - 1, conv_dim),
        "groups_ssm": f32(n_groups, per, batch, *ssm),
        "attn_k": mk(n_groups, batch, max_len, k1 - k0, cfg.head_dim),
        "attn_v": mk(n_groups, batch, max_len, k1 - k0, cfg.head_dim),
    }
    if tail:
        cache["tail_conv"] = mk(tail, batch, cfg.ssm_conv - 1, conv_dim)
        cache["tail_ssm"] = f32(tail, batch, *ssm)
    return cache


def decode_step(params: Params, token: torch.Tensor, cache, pos,
                cfg: ModelConfig, *, backend: str = "torch"):
    """token (B, s): s = 1 decodes, s > 1 prefills into the cache at
    ``pos`` (a host int or a 0-d integer tensor on the device, as
    ``transformer.decode_step``'s). Returns (logits (B, V), cache), the
    cache updated in place (placed parameters: a ``layers.SplitCache``)."""
    per, n_groups, tail = _geometry(cfg)

    def row(params, token, caches):
        s = token.shape[1]
        prefill = s > 1
        trees = position_trees(params, cfg, _position_tree)
        shared = [t["shared"] for t in trees]
        where = [at_positions(pos, s, t["embed"].device)[None, :]
                 for t in trees]
        xs = embed_positions(trees, token)
        for g in range(n_groups):
            for i in range(per):
                xs = mamba_block_cached(
                    [layer_at(t["groups"], g, i) for t in trees], xs, cfg,
                    [c["groups_conv"][g, i] for c in caches],
                    [c["groups_ssm"][g, i] for c in caches],
                    zero_state=prefill)
            xs = _shared_block(
                shared, xs, cfg, positions=where, caches=[
                    {"k": c["attn_k"][g], "v": c["attn_v"][g]}
                    for c in caches], cache_pos=pos, backend=backend)
        for i in range(tail):
            xs = mamba_block_cached(
                [layer_at(t["tail"], i) for t in trees], xs, cfg,
                [c["tail_conv"][i] for c in caches],
                [c["tail_ssm"][i] for c in caches], zero_state=prefill)
        return head_logits(trees, [x[:, -1] for x in xs], cfg)

    return decode_rows(params, token, cache, row)
