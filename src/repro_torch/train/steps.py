"""Model-family dispatch for serving (port of the serving half of the
reference's ``train/steps.py``): ``init_params``, ``init_cache`` and
``make_serve_steps``. Only the dense family is ported; the others, and
training, raise ``NotImplementedError`` (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import torch

from repro_torch.compat import resolve_backend, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: serving the {cfg.family!r} family is not ported "
            f"yet; the port serves the dense family (ROADMAP Queue 1, "
            f"item 11)")


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` on ``device`` (``None``:
    the CUDA card; the generator must live there)."""
    _require_ported(cfg)
    return transformer.init_params(cfg, generator, resolve_device(device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """A zeroed KV cache for ``max_len`` positions on ``device`` (``None``:
    the CUDA card)."""
    _require_ported(cfg)
    return transformer.init_kv_cache(cfg, batch, max_len,
                                     resolve_device(device))


def make_serve_steps(cfg: ModelConfig, backend: str = "torch"):
    """Returns (prefill, decode): ``decode(params, token, cache, pos)`` and
    ``prefill(params, tokens, cache)``, each -> (last-token logits, cache),
    run without autograd. ``backend`` picks the long-sequence attention
    ("hopper": K6, "torch": the scan)."""
    _require_ported(cfg)
    backend = resolve_backend(backend)

    @torch.no_grad()
    def decode(params, token, cache, pos):
        return transformer.decode_step(params, token, cache, pos, cfg,
                                       backend=backend)

    @torch.no_grad()
    def prefill(params, tokens, cache):
        return transformer.prefill(params, tokens, cache, cfg,
                                   backend=backend)

    return prefill, decode
