"""Fake-tensor stand-ins for every model input, allocating nothing (port of
the reference's ``launch/specs.py``).

``input_specs(cfg, shape)`` returns the arg-specs dict of one (arch x
shape) cell; together with ``abstract_params`` these are everything the
dry-run (``launch/dryrun.py``) traces a step on. Fake tensors
(``FakeTensorMode``) take the place of ``jax.ShapeDtypeStruct``: each has
its shape and dtype and no storage. They are built on the CPU device type
from a CPU generator (a generator on ``meta`` is refused), so no card is
touched. Every fake tensor of one trace must come from one mode (two
fake modes do not mix): each function takes ``mode`` and makes its own
when given none.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.train import steps


def abstract_params(cfg: ModelConfig, mode: FakeTensorMode | None = None):
    """The params tree of ``cfg`` as fake tensors."""
    with mode or FakeTensorMode():
        return steps.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   mode: FakeTensorMode | None = None, device="cpu"):
    """The serving cache of ``cfg`` for ``batch`` rows and ``max_len``
    positions as fake tensors on ``device`` (under ``use_rules`` of a
    splitting mesh, its ``layers.SplitCache``: ``device`` is the mesh's
    first)."""
    with mode or FakeTensorMode():
        return steps.init_cache(cfg, batch, max_len, device)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                mode: FakeTensorMode | None = None, device="cpu") -> dict:
    """Model-input fake tensors for one (arch x shape) cell, on
    ``device`` (the cache as :func:`abstract_cache` makes it)."""
    mode = mode or FakeTensorMode()
    b, s = shape.global_batch, shape.seq_len
    dt = cfg.torch_dtype

    def fake(size, dtype):
        with mode:
            return torch.empty(size, dtype=dtype, device=device)

    def extras(frames_key: str) -> dict:
        out = {}
        if cfg.family == "vlm":
            out["image_embeds"] = fake((b, cfg.n_image_tokens, cfg.d_model),
                                       dt)
        if cfg.family == "audio":
            out[frames_key] = fake((b, cfg.n_audio_frames, cfg.d_model), dt)
        return out

    if shape.kind == "train":
        return {"tokens": fake((b, s), torch.int32),
                "targets": fake((b, s), torch.int32), **extras("frames")}
    if shape.kind == "prefill":
        return {"tokens": fake((b, s), torch.int32),
                "cache": abstract_cache(cfg, b, s, mode, device),
                "extras": extras("enc_out")}
    if shape.kind == "decode":
        return {"token": fake((b, 1), torch.int32),
                "cache": abstract_cache(cfg, b, s, mode, device),
                "pos": fake((), torch.int32),
                "extras": extras("enc_out")}
    raise ValueError(shape.kind)
