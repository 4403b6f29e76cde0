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
with gradients per shard of the same placement.
"""
from __future__ import annotations

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
                   backend: str = "torch"):
    """(B, S) ``batch["tokens"]`` -> logits (B, S, V); a VLM also reads
    ``batch["image_embeds"]`` and whisper ``batch["frames"]``. ``backend``
    picks the long-sequence attention, as in :func:`make_serve_steps`."""
    _family(cfg)
    tokens = batch["tokens"]
    if cfg.family in ("dense", "moe"):
        return transformer.forward(params, tokens, cfg, backend=backend)
    if cfg.family == "vlm":
        return transformer.forward(params, tokens, cfg,
                                   image_embeds=batch["image_embeds"],
                                   backend=backend)
    if cfg.family == "ssm":
        return mamba2.forward(params, tokens, cfg)
    if cfg.family == "hybrid":
        return zamba2.forward(params, tokens, cfg, backend=backend)
    return whisper.forward(params, tokens, batch["frames"], cfg,
                           backend=backend)


# ---------------------------------------------------------------------------
# loss / train step
# ---------------------------------------------------------------------------

class _CrossEntropy(torch.autograd.Function):
    """Mean next-token cross-entropy over (N, V) logits, one chunk of rows
    at a time: no float32 (N, V) tensor is ever held, and the backward
    writes ``softmax - onehot`` chunk by chunk into the logits' dtype. The
    arithmetic is the reference's, rounding point for rounding point: the
    row max in the logits' dtype, ``(logits - max)`` rounded to it before
    the float32 exp, and a gradient of ``exp(s) * (ct / sum)`` rounded to
    the logits' dtype, to which the gold column's ``-ct`` (rounded too) is
    added."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, targets: torch.Tensor):
        n, v = logits.shape
        rows = max(1, CE_CHUNK // v)
        m = torch.empty(n, dtype=logits.dtype, device=logits.device)
        sumexp = torch.empty(n, dtype=torch.float32, device=logits.device)
        for i in range(0, n, rows):
            x = logits[i:i + rows]
            m[i:i + rows] = x.amax(-1)
            shifted = (x - m[i:i + rows, None]).float()
            sumexp[i:i + rows] = torch.exp(shifted).sum(-1)
        lse = torch.log(sumexp) + m.float()
        gold = logits.gather(1, targets[:, None])[:, 0].float()
        ctx.save_for_backward(logits, targets, m, sumexp)
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, grad):
        logits, targets, m, sumexp = ctx.saved_tensors
        n, v = logits.shape
        rows = max(1, CE_CHUNK // v)
        ct = grad.float() / n
        row_ct = ct / sumexp
        out = torch.empty_like(logits)
        for i in range(0, n, rows):
            shifted = (logits[i:i + rows] - m[i:i + rows, None]).float()
            out[i:i + rows] = torch.exp(shifted).mul_(row_ct[i:i + rows, None])
        idx = torch.arange(n, device=logits.device)
        out[idx, targets] = out[idx, targets] + (-ct).to(out.dtype)
        return out, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """Mean next-token CE, accumulated in float32 without an fp32 copy of
    the (B, S, V) logits; the gold logit comes from a gather."""
    v = logits.shape[-1]
    return _CrossEntropy.apply(logits.reshape(-1, v),
                               targets.reshape(-1).long())


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
    first leaf's device."""
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    batch = _on_device(batch, leaves[0].device)
    logits = forward_logits(pytree.tree_unflatten(live, spec), batch, cfg)
    loss = cross_entropy(logits, batch["targets"])
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
