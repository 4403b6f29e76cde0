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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    Params,
    _init,
    attention,
    init_attention,
    init_swiglu,
    layer_at,
    remat_wrap,
    rms_norm,
    stack_layers,
    swiglu,
)
from repro_torch.models.mamba2 import (
    init_mamba_block,
    mamba_block,
    mamba_block_cached,
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


def _shared_block(shared: Params, x, cfg: ModelConfig, *, positions=None,
                  kv_cache=None, cache_pos=None, backend: str = "torch"):
    h, nc = attention(shared["attn"],
                      rms_norm(x, shared["norm"], cfg.norm_eps), cfg,
                      positions=positions, kv_cache=kv_cache,
                      cache_pos=cache_pos, backend=backend)
    x = x + h
    x = x + swiglu(shared["ffn"], rms_norm(x, shared["norm2"], cfg.norm_eps))
    return x, nc


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            backend: str = "torch") -> torch.Tensor:
    """(B, S) -> logits (B, S, V), without a cache. Under autograd each
    group (its mamba layers and the shared block) runs under
    ``remat_wrap``, as the reference's scanned group body; the tail runs
    unwrapped, as there."""
    per, n_groups, tail = _geometry(cfg)

    def group_body(x, group_p, shared):
        for i in range(per):
            x, _ = mamba_block(layer_at(group_p, i), x, cfg)
        return _shared_block(shared, x, cfg, backend=backend)[0]

    if torch.is_grad_enabled():
        group_body = remat_wrap(group_body, cfg)
    x = F.embedding(tokens.long(), params["embed"])
    for g in range(n_groups):
        x = group_body(x, layer_at(params["groups"], g), params["shared"])
    for i in range(tail):
        x, _ = mamba_block(layer_at(params["tail"], i), x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    per, n_groups, tail = _geometry(cfg)
    conv_dim = cfg.d_ssm + 2 * cfg.ssm_state
    ssm = (cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    mk = lambda *shape: torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=device)
    f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                     device=device)
    cache = {
        "groups_conv": mk(n_groups, per, batch, cfg.ssm_conv - 1, conv_dim),
        "groups_ssm": f32(n_groups, per, batch, *ssm),
        "attn_k": mk(n_groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim),
        "attn_v": mk(n_groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim),
    }
    if tail:
        cache["tail_conv"] = mk(tail, batch, cfg.ssm_conv - 1, conv_dim)
        cache["tail_ssm"] = f32(tail, batch, *ssm)
    return cache


def decode_step(params: Params, token: torch.Tensor, cache, pos: int,
                cfg: ModelConfig, *, backend: str = "torch"):
    """token (B, s): s = 1 decodes, s > 1 prefills into the cache at
    ``pos``. Returns (logits (B, V), cache), the cache updated in place."""
    per, n_groups, tail = _geometry(cfg)
    pos = int(pos)
    s = token.shape[1]
    prefill = s > 1
    x = params["embed"][token.long()]
    positions = pos + torch.arange(s, device=x.device)[None, :]
    for g in range(n_groups):
        for i in range(per):
            x = mamba_block_cached(
                layer_at(params["groups"], g, i), x, cfg,
                cache["groups_conv"][g, i], cache["groups_ssm"][g, i],
                zero_state=prefill)
        x, _ = _shared_block(
            params["shared"], x, cfg, positions=positions,
            kv_cache={"k": cache["attn_k"][g], "v": cache["attn_v"][g]},
            cache_pos=pos, backend=backend)
    for i in range(tail):
        x = mamba_block_cached(layer_at(params["tail"], i), x, cfg,
                               cache["tail_conv"][i], cache["tail_ssm"][i],
                               zero_state=prefill)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1] @ params["lm_head"], cache
