"""Model configuration schema + the architecture registry (port of the
reference's ``configs/base.py``).

One ``ModelConfig`` describes any architecture in the assigned pool (dense /
MoE / VLM / hybrid-SSM / audio enc-dec / pure SSM) plus the paper's own VGG16.
The fields, ``reduced()`` and ``param_count()`` equal the reference's field
for field; ``torch_dtype`` takes the place of ``jnp_dtype``. Reduced configs
(``cfg.reduced()``) drive the CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | hybrid | audio | ssm | cnn
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 128
    qk_norm: bool = False
    attn_bias: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 1
    moe_every: int = 1           # MoE FFN every N layers (2 = alternating)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    # --- hybrid (zamba2): one shared attention block every N mamba blocks ---
    shared_attn_every: int = 0
    # --- VLM ---
    cross_attn_every: int = 0    # cross-attention layer every N layers
    n_image_tokens: int = 0      # stub frontend: precomputed patch embeddings
    # --- audio enc-dec (whisper) ---
    encoder_layers: int = 0
    n_audio_frames: int = 0      # stub frontend: precomputed frame embeddings
    # --- misc ---
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "none"   # "none" (save nothing) | "dots"
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        dtype = getattr(torch, self.dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dtype

    @property
    def d_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_ssm // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameters (approx; exact for the transformer families)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * 2  # embed + lm_head (untied)
        if self.family in ("dense", "moe", "vlm"):
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                + self.n_heads * self.head_dim * d
            dense_ffn = 3 * d * f
            n_moe = (self.n_layers // self.moe_every
                     if self.n_experts else 0)
            n_dense = self.n_layers - n_moe
            moe_ffn = 3 * d * f * self.n_experts + d * self.n_experts \
                + (3 * d * f if self.shared_expert else 0)
            per_cross = 0
            n_cross = 0
            if self.cross_attn_every:
                n_cross = self.n_layers // self.cross_attn_every
                per_cross = attn  # cross-attn block of the same shape
            return (emb + self.n_layers * (attn + 2 * d)
                    + n_dense * dense_ffn + n_moe * moe_ffn
                    + n_cross * per_cross)
        if self.family in ("ssm", "hybrid"):
            di = self.d_ssm
            per = d * (2 * di + 2 * self.ssm_state + self.n_ssm_heads) \
                + di * self.ssm_conv + di * d + 2 * d
            total = emb + self.n_layers * per
            if self.shared_attn_every:
                attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                    + self.n_heads * self.head_dim * d + 3 * d * self.d_ff
                total += attn  # one shared block
            return total
        if self.family == "audio":
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
                + self.n_heads * self.head_dim * d
            ffn = 2 * d * f  # whisper uses GELU MLP (w_in, w_out)
            enc = self.encoder_layers * (attn + ffn + 2 * d)
            dec = self.n_layers * (2 * attn + ffn + 3 * d)
            return emb + enc + dec
        return 0

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE top-1: one routed expert)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_moe = self.n_layers // self.moe_every
        inactive = 3 * d * f * (self.n_experts - self.experts_per_tok)
        return self.param_count() - n_moe * inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        def cap(v, c):
            return min(v, c) if v else v
        return dataclasses.replace(
            self,
            n_layers=cap(self.n_layers, 4) or 0,
            d_model=cap(self.d_model, 64),
            n_heads=cap(self.n_heads, 4),
            n_kv_heads=cap(self.n_kv_heads, 2),
            d_ff=cap(self.d_ff, 128),
            vocab_size=cap(self.vocab_size, 512),
            head_dim=16 if self.head_dim else 0,
            n_experts=cap(self.n_experts, 4),
            ssm_state=cap(self.ssm_state, 16),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            shared_attn_every=2 if self.shared_attn_every else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_image_tokens=cap(self.n_image_tokens, 16),
            encoder_layers=cap(self.encoder_layers, 2),
            n_audio_frames=cap(self.n_audio_frames, 32),
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import config modules lazily so the registry is populated
        from repro_torch.configs import all_configs  # noqa: F401
        if name not in _REGISTRY:
            raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch.configs import all_configs  # noqa: F401
    return sorted(_REGISTRY)
