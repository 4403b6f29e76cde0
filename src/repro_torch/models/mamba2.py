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

Tensor parallelism along ``model`` (ROADMAP 11i): over parameters placed
by ``train.steps.place`` each position computes whole SSM heads
``[i H / n, (i + 1) H / n)``, every position the one group's B and C.
Each position multiplies by its own shard of ``in_proj``'s flat columns
and takes its heads' columns from every position's product
(:func:`_projections`: activations cross, not weights); its conv
channels, ``out_proj`` rows and the rest come from :func:`take_block`.
The gated norm's variance and the ``out_proj`` product are all-reduced
(:func:`mamba_block` over the list of positions); the embedding, the
head and the split cache are ``models/layers.py``'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    Params,
    _init,
    _tp_ranges,
    decode_rows,
    embed_positions,
    head_logits,
    layer_at,
    position_trees,
    remat_wrap,
    rms_norm,
    stack_layers,
)
from repro_torch.parallel import sharding


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


def _projections(p: list, x: list, cfg: ModelConfig) -> list:
    """Each ``model`` position's ``in_proj`` product at its SSM heads: its
    z and x columns, every B and C column, its dt columns (None for a
    position that holds no SSM head). A position multiplies the normed
    input by the ``in_proj`` it holds: its shard of the flat ``2 di + 2 N
    + H`` columns, which the reference splits evenly across the segments,
    so it then takes its columns from every position's product
    (``sharding.take_parts``; a position without a head still multiplies,
    for the others); or, where the columns do not divide over the
    positions, the whole matrix, and its own product's columns. One
    position's product is the whole one."""
    n = len(p)
    if n == 1:
        return [rms_norm(x[0], p[0]["norm"], cfg.norm_eps) @ p[0]["in_proj"]]
    di, ns, pdim = cfg.d_ssm, cfg.ssm_state, cfg.ssm_head_dim
    tail = 2 * di + 2 * ns
    split = p[0]["in_proj"].shape[-1] != tail + cfg.n_ssm_heads
    heads = [_tp_ranges(cfg, n, i)["ssm_heads"] for i in range(n)]
    flat = [rms_norm(xi, pi["norm"], cfg.norm_eps) @ pi["in_proj"]
            if split or h1 > h0 else None
            for pi, xi, (h0, h1) in zip(p, x, heads)]
    out = []
    for i, (h0, h1) in enumerate(heads):
        if h1 == h0:
            out.append(None)
            continue
        c0, c1 = h0 * pdim, h1 * pdim
        out.append(torch.cat([
            sharding.take_parts(flat, -1, a, b, i) if split
            else flat[i][..., a:b]
            for a, b in ((c0, c1), (di + c0, di + c1), (2 * di, tail),
                         (tail + h0, tail + h1))], -1))
    return out


def _gated(p: Params, proj, cfg: ModelConfig, ssm_cache, chunk: int):
    """The block from its ``in_proj`` product (:func:`_projections`) up to
    its gated norm, at one ``model`` position's SSM heads (read from
    ``A_log``'s shape): ``y * silu(z)`` (B, L, heads * P) and the new
    cache (or None)."""
    bsz, l, _ = proj.shape
    n, pdim = cfg.ssm_state, cfg.ssm_head_dim
    h = p["A_log"].shape[-1]
    di = h * pdim

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
    new_cache = ({"conv": new_conv, "ssm": new_ssm}
                 if ssm_cache is not None else None)
    return y * F.silu(z), new_cache


def mamba_block(p: list, x: list, cfg: ModelConfig, *, ssm_cache=None,
                chunk: int = 64):
    """x + block(x) over the ``model`` positions: ``p`` each position's
    layer tree, ``x`` its (B, L, D) replicated activations, ``ssm_cache``
    None (a forward without cache) or each position's {"conv": (B, K-1,
    C), "ssm": (B, H, N, P)} at its SSM heads, carried into the block
    (decode, or a prefill into the cache). Returns the lists of outputs
    and new caches; an unplaced tree is the one position.

    Each position computes its heads up to ``y * silu(z)``; the gated
    norm's float32 sums of squares are all-reduced (the variance over all
    ``d_ssm`` channels); each position normalises its channels and gives
    its partial sum of the row-split ``out_proj`` product, all-reduced
    before the residual add. A position that holds no SSM head gives
    zeros to both all-reduces, and None for its new cache."""
    caches = ssm_cache or [None] * len(p)
    gs, new = zip(*((None, None) if pr is None
                    else _gated(pi, pr, cfg, c, chunk) for pi, pr, c in
                    zip(p, _projections(p, x, cfg), caches)))
    sums = sharding.all_reduce_sum(
        [xi.new_zeros(xi.shape[:-1] + (1,), dtype=torch.float32)
         if g is None else g.float().square().sum(-1, keepdim=True)
         for xi, g in zip(x, gs)])
    outs = [torch.zeros_like(xi) if g is None else
            (g * torch.rsqrt(ss / cfg.d_ssm + cfg.norm_eps).to(g.dtype)
             * pi["norm2"]) @ pi["out_proj"]
            for pi, xi, g, ss in zip(p, x, gs, sums)]
    return ([xi + o for xi, o in zip(x, sharding.all_reduce_sum(outs))],
            list(new))


def mamba_block_cached(p: list, x: list, cfg: ModelConfig, conv: list,
                       ssm: list, *, zero_state: bool = False) -> list:
    """``mamba_block`` over one layer's cache slots, each position's
    ``conv`` (B, K-1, C) and ``ssm`` (B, H, N, P), views that take the new
    states in place; ``zero_state`` starts from zeroed states instead (the
    reference's ``* 0``). Returns each position's output."""
    states = [{"conv": c * 0, "ssm": s * 0} if zero_state
              else {"conv": c, "ssm": s} for c, s in zip(conv, ssm)]
    xs, new = mamba_block(p, x, cfg, ssm_cache=states)
    for c, s, nc in zip(conv, ssm, new):
        if nc is not None:
            c.copy_(nc["conv"])
            s.copy_(nc["ssm"])
    return xs


def conv_channels(cfg: ModelConfig, share: dict | None) -> tuple[int, int]:
    """(SSM heads, conv channels) of a model position's ``share``
    (``layers._tp_ranges``; None: the whole block); a share of no head
    holds no channel."""
    h0, h1 = share["ssm_heads"] if share else (0, cfg.n_ssm_heads)
    if h1 == h0:
        return 0, 0
    return h1 - h0, (h1 - h0) * cfg.ssm_head_dim + 2 * cfg.ssm_state


def init_ssm_cache(cfg: ModelConfig, batch: int, device,
                   share: dict | None = None):
    """Stacked per-layer decode cache (a model position's ``share``: its
    SSM heads and conv channels)."""
    h, conv_dim = conv_channels(cfg, share)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=cfg.torch_dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_state,
                            cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


def take_block(lp: Params, cfg: ModelConfig, r: dict, i: int) -> Params:
    """Position ``i``'s mamba layer tree (share ``r``; stacked leaves, any
    leading dimensions): its SSM heads ``[h0, h1)``. ``in_proj`` is what
    the position holds (:func:`_projections` takes its columns from the
    products); the conv's channels, its x channels then every B and C
    channel (one state group: each position computes B and C), are
    assembled from takes; ``A_log``, ``D``, ``dt_bias`` at its heads;
    ``norm2`` (replicated) and ``out_proj``'s rows at its channels. A
    position that holds no SSM head keeps its ``norm`` and ``in_proj``
    only (its product's columns are other positions')."""
    di, n, pdim = cfg.d_ssm, cfg.ssm_state, cfg.ssm_head_dim
    h0, h1 = r["ssm_heads"]
    if h1 == h0:
        return {"norm": lp["norm"].at(i), "in_proj": lp["in_proj"].at(i)}
    c0, c1 = h0 * pdim, h1 * pdim

    def cols(w, *ranges):
        return torch.cat([w.take(-1, a, b, i) for a, b in ranges], -1)

    bc = (di, di + 2 * n)          # the conv's B and C channels
    return {
        "norm": lp["norm"].at(i),
        "in_proj": lp["in_proj"].at(i),
        "conv_w": cols(lp["conv_w"], (c0, c1), bc),
        "conv_b": cols(lp["conv_b"], (c0, c1), bc),
        **{name: lp[name].take(-1, h0, h1, i)
           for name in ("A_log", "D", "dt_bias")},
        "norm2": lp["norm2"].take(-1, c0, c1, i),
        "out_proj": lp["out_proj"].take(-2, c0, c1, i),
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


def _position_tree(params: Params, cfg: ModelConfig, i: int) -> Params:
    r = _tp_ranges(cfg, params["embed"].n, i)
    return {"embed": params["embed"].take(-1, *r["embed"], i),
            "layers": take_block(params["layers"], cfg, r, i),
            "final_norm": params["final_norm"].at(i),
            "lm_head": params["lm_head"].take(-1, *r["vocab"], i)}


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            shares: bool = False):
    """(B, S) -> logits (B, S, V), without a cache, on the first
    position's device (with ``shares``, each position's vocabulary share
    on its own, ``layers.head_logits``). Under autograd each layer runs
    under ``remat_wrap``, as the reference's scanned body."""
    def body(xs, layer_ps):
        return mamba_block(layer_ps, xs, cfg)[0]

    if torch.is_grad_enabled():
        body = remat_wrap(body, cfg)
    trees = position_trees(params, cfg, _position_tree)
    xs = embed_positions(trees, tokens)
    for i in range(cfg.n_layers):
        xs = body(xs, [layer_at(t["layers"], i) for t in trees])
    return head_logits(trees, xs, cfg, shares=shares)


def decode_step(params: Params, token: torch.Tensor, cache, pos: int,
                cfg: ModelConfig):
    """token (B, s); cache from init_ssm_cache (placed parameters: a
    ``layers.SplitCache``), carried into every layer (so a prefill of
    s > 1 tokens starts from the cache's state). Returns (logits (B, V),
    cache), the cache updated in place."""
    def row(params, token, caches):
        trees = position_trees(params, cfg, _position_tree)
        xs = embed_positions(trees, token)
        for i in range(cfg.n_layers):
            xs = mamba_block_cached(
                [layer_at(t["layers"], i) for t in trees], xs, cfg,
                [c["conv"][i] for c in caches], [c["ssm"][i] for c in caches])
        return head_logits(trees, [x[:, -1] for x in xs], cfg)

    return decode_rows(params, token, cache, row)
