"""Whisper-base: an encoder-decoder transformer, arXiv:2212.04356 (port of
the reference's ``models/whisper.py``).

The conv frontend is a stub, as in the reference: the input is
precomputed frame embeddings (B, n_frames, d_model). The encoder is a
bidirectional transformer without RoPE; the decoder runs causal
self-attention over its KV cache (no RoPE either), then cross-attention to
the encoder's states, then the GELU MLP. Positions are a learned table of
4096 rows (``pos_embed``), shared by frames and tokens.

Tensor parallelism along ``model`` (ROADMAP 11i): each position computes
whole heads of the encoder's self-attention and the decoder's self- and
cross-attention (the cross-attention's K/V heads from ``enc_out``,
replicated on every position), and its hidden units of the MLP, whose
``w_out`` partial sums are all-reduced before ``b_out`` is added once;
``pos_embed`` stays one master copy, the head a master copy (51865 columns
divide over no position count) from which each position cuts its
vocabulary share. Over placed parameters :func:`encode` returns the
states on the first position's device.
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
    init_mlp,
    layer_at,
    mlp,
    position_trees,
    remat_wrap,
    residual_attention,
    rms_norm,
    stack_layers,
    take_attention,
    take_mlp,
)
from repro_torch.parallel import sharding

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


def _position_tree(params: Params, cfg: ModelConfig, i: int) -> Params:
    r = _tp_ranges(cfg, params["embed"].n, i)

    def layer(lp):
        out = {name: lp[name].at(i) for name in ("norm", "norm2", "norm3")
               if name in lp}
        out["attn"] = take_attention(lp["attn"], cfg, r, i)
        if "xattn" in lp:
            out["xattn"] = take_attention(lp["xattn"], cfg, r, i)
        out["ffn"] = take_mlp(lp["ffn"], r, i)
        return out

    return {"enc_layers": layer(params["enc_layers"]),
            "dec_layers": layer(params["dec_layers"]),
            "embed": params["embed"].take(-1, *r["embed"], i),
            "pos_embed": params["pos_embed"].at(i),
            **{name: params[name].at(i) for name in ("enc_norm",
                                                     "final_norm")},
            "lm_head": params["lm_head"].take(-1, *r["vocab"], i)}


def _residual_mlp(ps: list, xs: list, cfg: ModelConfig) -> list:
    """``x + mlp(rms_norm(x, norm2))`` over the positions: each position's
    hidden units give its partial ``w_out`` product, all-reduced, then
    ``b_out`` is added once."""
    fs = [mlp(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps),
              out_bias=False) for p, x in zip(ps, xs)]
    return [x + (f + p["ffn"]["b_out"])
            for p, x, f in zip(ps, xs, sharding.all_reduce_sum(fs))]


def _encode(trees: list, frames: torch.Tensor, cfg: ModelConfig,
            backend: str) -> list:
    n = frames.shape[1]
    xs = [frames.to(t["pos_embed"].device)
          + t["pos_embed"][:n][None].to(frames.dtype) for t in trees]
    for i in range(cfg.encoder_layers):
        ps = [layer_at(t["enc_layers"], i) for t in trees]
        xs = residual_attention(ps, xs, cfg, causal=False, use_rope=False,
                                backend=backend)
        xs = _residual_mlp(ps, xs, cfg)
    return [rms_norm(x, t["enc_norm"], cfg.norm_eps)
            for x, t in zip(xs, trees)]


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           backend: str = "torch") -> torch.Tensor:
    """frames: (B, n_frames, d_model) stub frontend output -> encoder
    states (B, n_frames, d_model), on the first position's device."""
    return _encode(position_trees(params, cfg, _position_tree), frames, cfg,
                   backend)[0]


def _dec_layer(ps: list, xs: list, enc_out, cfg: ModelConfig, *,
               caches=None, cache_pos=None, backend: str = "torch") -> list:
    """One decoder layer over the positions (``caches``: each position's
    layer KV cache, or None)."""
    xs = residual_attention(ps, xs, cfg, caches=caches, cache_pos=cache_pos,
                            use_rope=False, backend=backend)
    xs = residual_attention(ps, xs, cfg, attn="xattn", norm="norm3",
                            xattn_kv=enc_out, causal=False, use_rope=False,
                            backend=backend)
    return _residual_mlp(ps, xs, cfg)


def _tokens(trees: list, tokens: torch.Tensor, pos) -> list:
    """The token embeddings plus their learned positions, a copy a
    position: the table's rows ``pos + arange(s)`` by ``index_select``,
    ``pos`` a host int or a 0-d integer tensor on the device."""
    s = tokens.shape[1]
    return [x + t["pos_embed"].index_select(
        0, at_positions(pos, s, t["pos_embed"].device))[None]
        for x, t in zip(embed_positions(trees, tokens), trees)]


def forward(params: Params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, *, backend: str = "torch",
            shares: bool = False):
    """frames (B, F, D) and tokens (B, S) -> logits (B, S, V), without a
    cache, on the first position's device (with ``shares``, each
    position's vocabulary share on its own, ``layers.head_logits``).
    Under autograd each decoder layer runs under ``remat_wrap``, as the
    reference's scanned body; the encoder runs unwrapped, as there."""
    def body(xs, ps, enc_out):
        return _dec_layer(ps, xs, enc_out, cfg, backend=backend)

    if torch.is_grad_enabled():
        body = remat_wrap(body, cfg)
    trees = position_trees(params, cfg, _position_tree)
    enc_out = _encode(trees, frames, cfg, backend)[0]
    xs = _tokens(trees, tokens, 0)
    for i in range(cfg.n_layers):
        xs = body(xs, [layer_at(t["dec_layers"], i) for t in trees], enc_out)
    return head_logits(trees, xs, cfg, shares=shares)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               share: dict | None = None):
    """The decoder's KV cache (a model position's ``share``,
    ``_tp_ranges``: its KV heads)."""
    k0, k1 = share["kv_heads"] if share else (0, cfg.n_kv_heads)
    shape = (cfg.n_layers, batch, max_len, k1 - k0, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def check_positions(pos: int, s: int) -> None:
    """``ValueError`` unless the positions ``pos .. pos + s - 1`` lie in
    the ``POS_ROWS``-row position table (a host check: the captured
    decode step, ``train.steps.DecodeStep``, makes it before any
    replay)."""
    if pos + s > POS_ROWS:
        raise ValueError(f"whisper: positions up to {pos + s} exceed the "
                         f"{POS_ROWS}-row position table")


def decode_step(params: Params, token: torch.Tensor, cache, pos,
                enc_out: torch.Tensor, cfg: ModelConfig, *,
                backend: str = "torch"):
    """token (B, s) at positions ``pos``..; ``enc_out`` the encoder's
    states. ``pos`` is a host int (checked against the position table
    here) or a 0-d integer tensor on the device (checked by the caller on
    the host, :func:`check_positions`). Returns (logits (B, V), cache),
    the cache updated in place (placed parameters: a
    ``layers.SplitCache``, each data row its share of the batch and of
    ``enc_out``)."""
    if not isinstance(pos, torch.Tensor):
        check_positions(pos, token.shape[1])

    def row(params, token, caches, enc_out):
        trees = position_trees(params, cfg, _position_tree)
        xs = _tokens(trees, token, pos)
        for i in range(cfg.n_layers):
            xs = _dec_layer(
                [layer_at(t["dec_layers"], i) for t in trees], xs, enc_out,
                cfg, caches=[{"k": c["k"][i], "v": c["v"][i]}
                             for c in caches],
                cache_pos=pos, backend=backend)
        return head_logits(trees, [x[:, -1] for x in xs], cfg)

    return decode_rows(params, token, cache, row, enc_out=enc_out)
