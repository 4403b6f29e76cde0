"""Mamba2 / SSD (state-space duality) blocks, arXiv:2405.21060 (port of the
reference's ``models/mamba2.py``).

Chunked SSD: a within-chunk quadratic form (attention-like, two-operand
batched products) and an inter-chunk state recurrence. Decode is a
constant-time state update. No hand-written kernel lies on this path: the
reference's SSD is ``einsum`` and ``associative_scan``, not Pallas.

Layout: x (B, L, H, P) with H = d_inner/headdim heads, P = headdim;
B/C (B, L, N), one state group broadcast across heads; dt (B, L, H) after
the softplus; A (H,) negative. ``A_log``, ``D`` and ``dt_bias`` are float32
leaves in every model dtype, and so is the SSM state; the chunked SSD
computes in float32 and returns ``x.dtype``.

The decode caches (``conv``, ``ssm``) are written IN PLACE, as the
transformer's KV caches are (the reference donates them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    Params,
    _init,
    layer_at,
    remat_wrap,
    rms_norm,
    stack_layers,
)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_reference(x, dt, a, b, c, initial_state=None):
    """Sequential-recurrence oracle.

    x: (B, L, H, P); dt: (B, L, H); a: (H,); b, c: (B, L, N).
    Returns (y (B, L, H, P), final_state (B, H, N, P)).
    """
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    s = (torch.zeros((bsz, h, n, p), device=x.device) if initial_state is None
         else initial_state.float())
    ys = []
    for t in range(l):
        y, s = ssd_decode_step(s, x[:, t].float(), dt[:, t], a, b[:, t],
                               c[:, t])
        ys.append(y)
    return torch.stack(ys, 1).to(x.dtype), s


def _segsum(a_blk: torch.Tensor) -> torch.Tensor:
    """a_blk: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums:
    out[i, j] = sum_{k=j+1..i} a[k] for i >= j, -inf otherwise."""
    q = a_blk.shape[-1]
    cs = torch.cumsum(a_blk, -1)
    diff = cs[..., :, None] - cs[..., None, :]    # sum_{j+1..i} = cs[i]-cs[j]
    mask = torch.ones((q, q), dtype=torch.bool, device=a_blk.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def _chunk_states(log_decay: torch.Tensor, states: torch.Tensor):
    """The inter-chunk recurrence S_c = d_c * S_{c-1} + s_c over the chunks
    c, from S_{-1} = 0, for every c at once: log_decay (B, C, H) = log d,
    states (B, C, H, N, P) -> (B, C, H, N, P). The reference's associative
    scan becomes one batched product with the lower-triangular matrix
    ``exp(sum_{k=z+1..c} log d_k)``, whose sums are taken term by term,
    not as differences of cumulative sums (over a long prompt those run far
    below 0, where their differences lose the bits that matter)."""
    bsz, nc, h = log_decay.shape
    ld = log_decay.transpose(1, 2)[..., :, None].expand(bsz, h, nc, nc)
    ones = torch.ones((nc, nc), dtype=torch.bool, device=ld.device)
    # [k, z] = log d_k for k > z, summed over k <= c: [c, z]
    seg = ld.masked_fill(~ones.tril(-1), 0.0).cumsum(-2)
    decay = torch.exp(seg).masked_fill(~ones.tril(), 0.0)  # (B, H, C, C)
    flat = states.permute(0, 2, 1, 3, 4).reshape(bsz, h, nc, -1)
    out = torch.matmul(decay, flat)                        # (B, H, C, N*P)
    return out.reshape(bsz, h, nc, *states.shape[3:]).permute(0, 2, 1, 3, 4)


def ssd_chunked(x, dt, a, b, c, chunk: int = 64, initial_state=None):
    """Chunked SSD (the paper-efficient algorithm). Same signature as ref."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    lp = l + pad
    nc = lp // q

    xc = x.reshape(bsz, nc, q, h, p).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b.reshape(bsz, nc, q, n).float()
    cc = c.reshape(bsz, nc, q, n).float()

    adt_h = (dtc * a).transpose(2, 3)              # (B, nc, H, Q) log-decay
    dt_h = dtc.transpose(2, 3)                     # (B, nc, H, Q)
    x_h = xc.permute(0, 1, 3, 2, 4)                # (B, nc, H, Q, P)

    # 1) within-chunk (diagonal blocks): quadratic attention-like form,
    # two operands at a time: the weight matrix W is (B, nc, H, Q, Q) and
    # W x one batched product (a single four-operand einsum may build a
    # (B, nc, H, Q, Q, P) intermediate, ~15 GB a layer at zamba2 2 x 4096)
    lmat = torch.exp(_segsum(adt_h))               # (B, nc, H, Q, Q)
    scores = torch.matmul(cc, bc.transpose(-1, -2))  # (B, nc, Q, Q)
    w_diag = scores[:, :, None] * lmat * dt_h[..., None, :]
    del lmat
    y = torch.matmul(w_diag, x_h)                  # (B, nc, H, Q, P)
    del w_diag

    # 2) chunk-final states: contribution of step j decays by a_{j+1..Q-1}
    cs = torch.cumsum(adt_h, -1)
    decay_states = torch.exp(cs[..., -1:] - cs)    # (B, nc, H, Q)
    xw = x_h * (decay_states * dt_h)[..., None]    # (B, nc, H, Q, P)
    states = torch.einsum("bcjn,bchjp->bchnp", bc, xw)  # (B, nc, H, N, P)

    # 3) inter-chunk recurrence
    log_decay = adt_h.sum(-1)                      # (B, nc, H)
    if initial_state is not None:
        states = torch.cat([initial_state.float()[:, None], states], 1)
        log_decay = F.pad(log_decay, (0, 0, 1, 0))    # decay 1 into chunk 0
        states_cum = _chunk_states(log_decay, states)
        prev_states = states_cum[:, :-1]           # state entering chunk c
    else:
        states_cum = _chunk_states(log_decay, states)
        prev_states = torch.cat([torch.zeros_like(states_cum[:, :1]),
                                 states_cum[:, :-1]], 1)
    final_state = states_cum[:, -1]

    # 4) off-diagonal contribution: C_i * decay(0..i) * S_prev, as
    # (C S_prev) scaled by the decay, two operands at a time
    decay_out = torch.exp(cs)                      # (B, nc, H, Q)
    y_off = torch.einsum("bcin,bchnp->bchip", cc, prev_states)
    y = y + y_off * decay_out[..., None]

    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, lp, h, p)[:, :l]
    return y.to(x.dtype), final_state


def ssd_decode_step(state, xt, dtt, a, bt, ct):
    """One-token state update: state (B,H,N,P) -> (y (B,H,P), new state)."""
    decay = torch.exp(dtt * a)
    new_state = state * decay[..., None, None] + (
        dtt[:, :, None, None] * bt.float()[:, None, :, None]
        * xt.float()[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", ct.float(), new_state)
    return y.to(xt.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     device) -> Params:
    d, di, n, h = cfg.d_model, cfg.d_ssm, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = di + 2 * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "in_proj": _init(gen, (d, 2 * di + 2 * n + h), dtype=dtype,
                         device=device),
        "conv_w": _init(gen, (cfg.ssm_conv, conv_dim), scale=0.5,
                        dtype=dtype, device=device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm2": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": _init(gen, (di, d), dtype=dtype, device=device),
    }


def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv1d. u: (B, L, C); w: (K, C); state: (B, K-1, C).
    Returns (out, new_state)."""
    k = w.shape[0]
    if state is None:
        up = F.pad(u, (0, 0, k - 1, 0))
    else:
        up = torch.cat([state.to(u.dtype), u], 1)
    new_state = up[:, -(k - 1):] if k > 1 else None
    # windowed sum: sum_t w[t] * u[i - (K-1) + t], in the reference's order
    out = 0
    for t in range(k):
        out = out + w[t] * up[:, t:t + u.shape[1]]
    return out + b, new_state


def mamba_block(p: Params, x, cfg: ModelConfig, *, ssm_cache=None,
                chunk: int = 64):
    """x: (B, L, D) -> (x + block(x), new cache). ssm_cache: {"conv":
    (B, K-1, C), "ssm": (B, H, N, P)}, carried into the block (decode, or a
    prefill into the cache); None for a forward without cache."""
    bsz, l, _ = x.shape
    di, n, h = cfg.d_ssm, cfg.ssm_state, cfg.n_ssm_heads
    pdim = cfg.ssm_head_dim

    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    proj = xn @ p["in_proj"]
    z, xin, b_, c_, dt = torch.split(proj, [di, di, n, n, h], -1)

    conv_in = torch.cat([xin, b_, c_], -1)
    conv_state = ssm_cache["conv"] if ssm_cache else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    conv_out = F.silu(conv_out)
    xin, b_, c_ = torch.split(conv_out, [di, n, n], -1)

    a = -torch.exp(p["A_log"])                                 # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xin.reshape(bsz, l, h, pdim)

    if ssm_cache is not None and l == 1:
        y, new_ssm = ssd_decode_step(
            ssm_cache["ssm"], xh[:, 0], dt[:, 0], a, b_[:, 0], c_[:, 0])
        y = y[:, None]
    else:
        init_s = ssm_cache["ssm"] if ssm_cache else None
        y, new_ssm = ssd_chunked(xh, dt, a, b_, c_, chunk=chunk,
                                 initial_state=init_s)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, l, di)
    y = rms_norm(y * F.silu(z), p["norm2"], cfg.norm_eps)
    out = y @ p["out_proj"]
    new_cache = ({"conv": new_conv, "ssm": new_ssm}
                 if ssm_cache is not None else None)
    return x + out, new_cache


def mamba_block_cached(p: Params, x, cfg: ModelConfig, conv, ssm, *,
                       zero_state: bool = False):
    """``mamba_block`` over one layer's cache slots ``conv`` (B, K-1, C)
    and ``ssm`` (B, H, N, P), views that take the new states in place;
    ``zero_state`` starts from zeroed states instead (the reference's
    ``* 0``). Returns the block's output."""
    state = ({"conv": conv * 0, "ssm": ssm * 0} if zero_state
             else {"conv": conv, "ssm": ssm})
    x, nc = mamba_block(p, x, cfg, ssm_cache=state)
    conv.copy_(nc["conv"])
    ssm.copy_(nc["ssm"])
    return x


def init_ssm_cache(cfg: ModelConfig, batch: int, device):
    """Stacked per-layer decode cache."""
    conv_dim = cfg.d_ssm + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=cfg.torch_dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.n_ssm_heads,
                            cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# full model (mamba2-130m: pure SSM stack)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters at the reference's scales, drawn from
    ``generator`` on ``device``."""
    dtype = cfg.torch_dtype
    layers = stack_layers(
        lambda: init_mamba_block(generator, cfg, dtype, device), cfg.n_layers)
    return {
        "embed": _init(generator, (cfg.vocab_size, cfg.d_model), scale=1.0,
                       dtype=dtype, device=device),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": _init(generator, (cfg.d_model, cfg.vocab_size),
                         dtype=dtype, device=device),
    }


def forward(params: Params, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """(B, S) -> logits (B, S, V), without a cache. Under autograd each
    layer runs under ``remat_wrap``, as the reference's scanned body."""
    def body(x, layer_p):
        return mamba_block(layer_p, x, cfg)[0]

    if torch.is_grad_enabled():
        body = remat_wrap(body, cfg)
    x = F.embedding(tokens.long(), params["embed"])
    for i in range(cfg.n_layers):
        x = body(x, layer_at(params["layers"], i))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"]


def decode_step(params: Params, token: torch.Tensor, cache, pos: int,
                cfg: ModelConfig):
    """token (B, s); cache from init_ssm_cache, carried into every layer
    (so a prefill of s > 1 tokens starts from the cache's state). Returns
    (logits (B, V), cache), the cache updated in place."""
    x = params["embed"][token.long()]
    for i in range(cfg.n_layers):
        x = mamba_block_cached(layer_at(params["layers"], i), x, cfg,
                               cache["conv"][i], cache["ssm"][i])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1] @ params["lm_head"], cache
