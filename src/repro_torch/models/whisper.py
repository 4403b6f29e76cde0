"""Whisper-base: an encoder-decoder transformer, arXiv:2212.04356 (port of
the reference's ``models/whisper.py``).

The conv frontend is a stub, as in the reference: the input is
precomputed frame embeddings (B, n_frames, d_model). The encoder is a
bidirectional transformer without RoPE; the decoder runs causal
self-attention over its KV cache (no RoPE either), then cross-attention to
the encoder's states, then the GELU MLP. Positions are a learned table of
4096 rows (``pos_embed``), shared by frames and tokens.
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
    init_mlp,
    layer_at,
    mlp,
    remat_wrap,
    rms_norm,
    stack_layers,
)

POS_ROWS = 4096


def _init_enc_layer(gen, cfg: ModelConfig, dtype, device) -> Params:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return {
        "norm": ones(),
        "attn": init_attention(gen, cfg, dtype, device),
        "norm2": ones(),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _init_dec_layer(gen, cfg: ModelConfig, dtype, device) -> Params:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return {
        "norm": ones(),
        "attn": init_attention(gen, cfg, dtype, device),
        "norm3": ones(),
        "xattn": init_attention(gen, cfg, dtype, device),
        "norm2": ones(),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters at the reference's scales, drawn from
    ``generator`` on ``device``."""
    dtype = cfg.torch_dtype
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return {
        "enc_layers": stack_layers(
            lambda: _init_enc_layer(generator, cfg, dtype, device),
            cfg.encoder_layers),
        "dec_layers": stack_layers(
            lambda: _init_dec_layer(generator, cfg, dtype, device),
            cfg.n_layers),
        "embed": _init(generator, (cfg.vocab_size, cfg.d_model), scale=1.0,
                       dtype=dtype, device=device),
        "pos_embed": _init(generator, (POS_ROWS, cfg.d_model), scale=0.02,
                           dtype=dtype, device=device),
        "enc_norm": ones(),
        "final_norm": ones(),
        "lm_head": _init(generator, (cfg.d_model, cfg.vocab_size),
                         dtype=dtype, device=device),
    }


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           backend: str = "torch") -> torch.Tensor:
    """frames: (B, n_frames, d_model) stub frontend output -> encoder
    states (B, n_frames, d_model)."""
    n = frames.shape[1]
    x = frames + params["pos_embed"][:n][None].to(frames.dtype)
    for i in range(cfg.encoder_layers):
        lp = layer_at(params["enc_layers"], i)
        h, _ = attention(lp["attn"], rms_norm(x, lp["norm"], cfg.norm_eps),
                         cfg, causal=False, use_rope=False, backend=backend)
        x = x + h
        x = x + mlp(lp["ffn"], rms_norm(x, lp["norm2"], cfg.norm_eps))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(lp: Params, x, enc_out, cfg: ModelConfig, *, kv_cache=None,
               cache_pos=None, backend: str = "torch"):
    h, nc = attention(lp["attn"], rms_norm(x, lp["norm"], cfg.norm_eps), cfg,
                      kv_cache=kv_cache, cache_pos=cache_pos, use_rope=False,
                      backend=backend)
    x = x + h
    xh, _ = attention(lp["xattn"], rms_norm(x, lp["norm3"], cfg.norm_eps),
                      cfg, xattn_kv=enc_out, causal=False, use_rope=False,
                      backend=backend)
    x = x + xh
    x = x + mlp(lp["ffn"], rms_norm(x, lp["norm2"], cfg.norm_eps))
    return x, nc


def forward(params: Params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, *, backend: str = "torch") -> torch.Tensor:
    """frames (B, F, D) and tokens (B, S) -> logits (B, S, V), without a
    cache. Under autograd each decoder layer runs under ``remat_wrap``, as
    the reference's scanned body; the encoder runs unwrapped, as there."""
    def body(x, lp, enc_out):
        return _dec_layer(lp, x, enc_out, cfg, backend=backend)[0]

    if torch.is_grad_enabled():
        body = remat_wrap(body, cfg)
    enc_out = encode(params, frames, cfg, backend=backend)
    s = tokens.shape[1]
    x = F.embedding(tokens.long(), params["embed"]) \
        + params["pos_embed"][:s][None]
    for i in range(cfg.n_layers):
        x = body(x, layer_at(params["dec_layers"], i), enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def decode_step(params: Params, token: torch.Tensor, cache, pos: int,
                enc_out: torch.Tensor, cfg: ModelConfig, *,
                backend: str = "torch"):
    """token (B, s) at positions ``pos``..; ``enc_out`` the encoder's
    states. Returns (logits (B, V), cache), the cache updated in place."""
    pos = int(pos)
    s = token.shape[1]
    if pos + s > POS_ROWS:
        raise ValueError(f"whisper: positions up to {pos + s} exceed the "
                         f"{POS_ROWS}-row position table")
    x = params["embed"][token.long()] + params["pos_embed"][pos:pos + s][None]
    for i in range(cfg.n_layers):
        x, _ = _dec_layer(layer_at(params["dec_layers"], i), x, enc_out, cfg,
                          kv_cache={"k": cache["k"][i], "v": cache["v"][i]},
                          cache_pos=pos, backend=backend)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1] @ params["lm_head"], cache
