"""Model-family dispatch: train step, prefill and decode builders (port of
the reference's ``train/steps.py``).

``make_train_step(cfg, opt)`` returns a step function ``(params,
opt_state, batch) -> (params, opt_state, metrics)``; ``make_serve_steps``
returns (prefill, decode). Every LM family serves and trains: dense and
MoE (``models/transformer.py``), VLM (the same module, with image
embeddings), SSM (mamba2), hybrid (zamba2) and audio (whisper).

Every LM family runs tensor parallel along the mesh's ``model`` axis
(ROADMAP 11i): :func:`place` splits a model's parameters by
``param_shardings`` (heads, hidden units, experts, SSM heads);
:func:`init_cache` under ``use_rules`` of a splitting mesh lays out the
family's cache over it (``layers.SplitCache``); the same functions then
run it tensor parallel (each model module over its ``model`` positions),
with gradients per shard of the same placement; training's loss reads the
logits as the positions' vocabulary shares, where they lie.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.compat import resolve_backend, resolve_device, to_tensor
from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer, whisper, zamba2
from repro_torch.models.layers import SplitCache
from repro_torch.models.layers import params_from_numpy  # noqa: F401
from repro_torch.optim import adamw
from repro_torch.parallel import sharding

# elements of logits per row chunk of ``cross_entropy`` (128 Mi: a 512 MiB
# float32 temporary, 524 rows at vocab 256000)
CE_CHUNK = 1 << 27


FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": mamba2, "hybrid": zamba2, "audio": whisper}


def _family(cfg: ModelConfig):
    """The model module of ``cfg``'s family; a family without one (the
    CNN) raises ``ValueError``, as the reference's dispatch does."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    return FAMILIES[cfg.family]


def place(cfg: ModelConfig, params, rules: sharding.Rules):
    """``params`` placed on ``rules``' mesh by ``param_shardings``:
    per-position shards where the mesh's ``model`` axis spans several
    positions, else every leaf on the mesh's first device."""
    _family(cfg)
    return sharding.place(params, sharding.param_shardings(params, rules))


# ---------------------------------------------------------------------------
# init / forward dispatch
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` on ``device`` (``None``:
    the CUDA card; the generator must live there)."""
    module = _family(cfg)
    return module.init_params(cfg, generator, resolve_device(device))


def forward_logits(params, batch: dict[str, Any], cfg: ModelConfig, *,
                   backend: str = "torch", shares: bool = False):
    """(B, S) ``batch["tokens"]`` -> logits (B, S, V); a VLM also reads
    ``batch["image_embeds"]`` and whisper ``batch["frames"]``. ``backend``
    picks the long-sequence attention, as in :func:`make_serve_steps`.
    With ``shares``, the list of the ``model`` positions' vocabulary
    shares (B, S, V_i), each on its position's device, ungathered (one
    for an unplaced tree): what :func:`cross_entropy` reads in
    training."""
    _family(cfg)
    tokens = batch["tokens"]
    if cfg.family in ("dense", "moe"):
        return transformer.forward(params, tokens, cfg, backend=backend,
                                   shares=shares)
    if cfg.family == "vlm":
        return transformer.forward(params, tokens, cfg,
                                   image_embeds=batch["image_embeds"],
                                   backend=backend, shares=shares)
    if cfg.family == "ssm":
        return mamba2.forward(params, tokens, cfg, shares=shares)
    if cfg.family == "hybrid":
        return zamba2.forward(params, tokens, cfg, backend=backend,
                              shares=shares)
    return whisper.forward(params, tokens, batch["frames"], cfg,
                           backend=backend, shares=shares)


# ---------------------------------------------------------------------------
# loss / train step
# ---------------------------------------------------------------------------

def _chunks(n: int, v: int):
    """The row ranges of ``cross_entropy``'s chunks over (n, v) logits."""
    rows = max(1, CE_CHUNK // v)
    return [(i, min(i + rows, n)) for i in range(0, n, rows)]


def _in_share(targets: torch.Tensor, offset: int, width: int):
    """Each target's column in the share ``[offset, offset + width)``
    (clamped into it) and whether it lies there."""
    col = targets - offset
    return col.clamp(0, width - 1), (col >= 0) & (col < width)


class _CrossEntropy(torch.autograd.Function):
    """Mean next-token cross-entropy over the (N, V_i) vocabulary shares of
    (N, V) logits, each on its ``model`` position's device (one share: the
    whole logits), one chunk of rows at a time: no float32 (N, V_i) tensor
    is ever held, and the backward writes ``softmax - onehot`` chunk by
    chunk into each share's dtype. The reference's scheme over its
    vocabulary-split logits: each position's row max in the logits' dtype,
    then their all-reduced max ``M`` (exact, so each ``(x - M)`` rounds as
    the reference's); each position's float32 sum of ``exp(x - M)`` over
    its columns, all-reduced in float64 and rounded once to float32; the
    gold logit from the share that holds each target (the others give 0),
    all-reduced. Three all-reduces of (N,) rows, and none in the
    backward, where each position writes its own share's gradient. The
    arithmetic is the reference's, rounding point for rounding point:
    ``(logits - M)`` rounded to the logits' dtype before the float32 exp,
    and a gradient of ``exp(s) * (ct / sum)`` rounded to the logits'
    dtype, to which the gold column's ``-ct`` (rounded too) is added."""

    @staticmethod
    def forward(ctx, targets: torch.Tensor, *shares: torch.Tensor):
        n = targets.shape[0]
        offsets = [0, *itertools.accumulate(x.shape[1] for x in shares[:-1])]
        tgts = [targets.to(x.device) for x in shares]
        maxes = []
        for x in shares:
            m = torch.empty(n, dtype=x.dtype, device=x.device)
            for i, j in _chunks(n, x.shape[1]):
                m[i:j] = x[i:j].amax(-1)
            maxes.append(m)
        maxes = sharding.all_reduce_max(maxes)
        sums, golds = [], []
        for x, m, t, o in zip(shares, maxes, tgts, offsets):
            sumexp = torch.empty(n, dtype=torch.float32, device=x.device)
            for i, j in _chunks(n, x.shape[1]):
                shifted = (x[i:j] - m[i:j, None]).float()
                sumexp[i:j] = torch.exp(shifted).sum(-1)
            sums.append(sumexp)
            col, inside = _in_share(t, o, x.shape[1])
            gold = x.gather(1, col[:, None])[:, 0].float()
            golds.append(torch.where(inside, gold, 0.0))
        # the positions' float32 sums added in float64: the all-reduce
        # rounds once, at its end (one share: the sum itself)
        sums = [t.float() for t in sharding.all_reduce_sum(
            [t.double() for t in sums])]
        gold = sharding.all_reduce_sum(golds)[0]
        lse = torch.log(sums[0]) + maxes[0].float()
        ctx.offsets = offsets
        ctx.save_for_backward(*tgts, *shares, *maxes, *sums)
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, grad):
        k = len(ctx.offsets)
        saved = ctx.saved_tensors
        tgts, shares = saved[:k], saved[k:2 * k]
        maxes, sums = saved[2 * k:3 * k], saved[3 * k:]
        n = tgts[0].shape[0]
        ct = grad.float() / n
        outs = []
        for x, t, m, sumexp, o in zip(shares, tgts, maxes, sums,
                                      ctx.offsets):
            ct_x = ct.to(x.device)
            row_ct = ct_x / sumexp
            out = torch.empty_like(x)
            for i, j in _chunks(n, x.shape[1]):
                shifted = (x[i:j] - m[i:j, None]).float()
                out[i:j] = torch.exp(shifted).mul_(row_ct[i:j, None])
            col, inside = _in_share(t, o, x.shape[1])
            idx = torch.arange(n, device=x.device)
            out[idx, col] = out[idx, col] + torch.where(
                inside, (-ct_x).to(out.dtype), 0)
            outs.append(out)
        return (None, *outs)


def cross_entropy(logits, targets: torch.Tensor):
    """Mean next-token CE of the (B, S, V) logits, or of the list of their
    vocabulary shares (B, S, V_i) in column order, each on its position's
    device (``forward_logits(..., shares=True)``), accumulated in float32
    without an fp32 copy of any share and without gathering them; the
    gold logit comes from the share that holds it."""
    shares = [logits] if isinstance(logits, torch.Tensor) else list(logits)
    targets = targets.reshape(-1).long()
    return _CrossEntropy.apply(targets, *(
        x.reshape(targets.shape[0], x.shape[-1]) for x in shares))


def _on_device(batch: dict[str, Any], device: torch.device) -> dict:
    """The batch's arrays or tensors on ``device`` (integers kept)."""
    return {k: to_tensor(b, device) if not isinstance(b, torch.Tensor)
            else b.to(device) for k, b in batch.items()}


@torch.enable_grad()
def loss_and_grads(params, batch: dict[str, Any], cfg: ModelConfig):
    """(loss, grads): the mean CE of ``batch`` and its gradient with respect
    to every leaf of ``params`` (a tree of the same structure: over placed
    parameters, a gradient per shard, and one per replicated leaf's master
    copy, summed over the positions that read it). The batch goes to the
    first leaf's device. Over placed parameters the loss reads each
    position's vocabulary share of the logits where it lies
    (:func:`cross_entropy`): no position holds the whole logits."""
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    batch = _on_device(batch, leaves[0].device)
    shares = forward_logits(pytree.tree_unflatten(live, spec), batch, cfg,
                            shares=True)
    loss = cross_entropy(shares, batch["targets"])
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def make_train_step(cfg: ModelConfig, opt: adamw.AdamWConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``. The step updates ``params`` and
    ``opt_state`` in place (the reference donates both) and returns them;
    the metrics are 0-dim float32 tensors on the params' device. Training
    attention at 2048 tokens and more is the scan, as in the reference."""
    _family(cfg)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg)
        params, opt_state, om = adamw.update(opt, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    return train_step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """A zeroed cache for ``max_len`` positions on ``device`` (``None``:
    the CUDA card): KV caches, and the SSM's conv and state caches. Under
    ``use_rules`` of a mesh whose ``model`` axis spans several positions,
    a ``layers.SplitCache`` of the family's cache over that mesh;
    ``device`` must then be its first device."""
    _family(cfg)
    device = resolve_device(device)
    make = {
        "ssm": lambda b, d, s: mamba2.init_ssm_cache(cfg, b, d, s),
        "hybrid": lambda b, d, s: zamba2.init_cache(cfg, b, max_len, d, s),
        "audio": lambda b, d, s: whisper.init_cache(cfg, b, max_len, d, s),
    }.get(cfg.family,
          lambda b, d, s: transformer.init_kv_cache(cfg, b, max_len, d, s))
    rules = sharding.current_rules()
    if rules is not None:
        placement = sharding.NamedSharding(rules.mesh, sharding.P())
        if placement.splits:
            if device != placement.device:
                raise ValueError(f"a split cache lives on {rules.mesh!r}; "
                                 f"device {device} is not its first")
            return SplitCache(cfg, batch, placement, make)
    return make(batch, device, None)


def make_serve_steps(cfg: ModelConfig, backend: str = "torch"):
    """Returns (prefill, decode): ``decode(params, token, cache, pos,
    extras=None)`` and ``prefill(params, tokens, cache, extras=None)``,
    each -> (last-token logits, cache), run without autograd. ``extras``
    carries a VLM's ``image_embeds`` and whisper's ``enc_out`` (the
    encoder's states, :func:`whisper.encode`). ``backend`` picks the
    long-sequence attention ("hopper": K6, "torch": the scan)."""
    _family(cfg)
    backend = resolve_backend(backend)

    @torch.no_grad()
    def decode(params, token, cache, pos, extras=None):
        extras = extras or {}
        if cfg.family == "ssm":
            return mamba2.decode_step(params, token, cache, pos, cfg)
        if cfg.family == "hybrid":
            return zamba2.decode_step(params, token, cache, pos, cfg,
                                      backend=backend)
        if cfg.family == "audio":
            return whisper.decode_step(params, token, cache, pos,
                                       extras["enc_out"], cfg,
                                       backend=backend)
        return transformer.decode_step(
            params, token, cache, pos, cfg,
            image_embeds=extras.get("image_embeds"), backend=backend)

    def prefill(params, tokens, cache, extras=None):
        return decode(params, tokens, cache, 0, extras)

    return prefill, decode
