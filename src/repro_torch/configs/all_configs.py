"""The 10 assigned architectures (+ VGG16, the paper's own model), as data:
a port of the reference's ``configs/all_configs.py``.

Exact dimensions from the assignment; source tags in each docstring.
Import this module to populate the registry (``base.get_config`` does so
lazily).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


@register("llama4-scout-17b-16e")
def llama4_scout():
    """[moe] MoE every layer, 16 routed experts top-1 + shared expert.
    [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
    return ModelConfig(
        name="llama4-scout-17b-16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab_size=202048, head_dim=128,
        n_experts=16, experts_per_tok=1, moe_every=1, shared_expert=True)


@register("llama4-maverick-400b-a17b")
def llama4_maverick():
    """[moe] 128 routed experts top-1 + shared, MoE on alternating layers.
    [hf:meta-llama/Llama-4-Maverick-17B-128E; unverified]"""
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
        vocab_size=202048, head_dim=128,
        n_experts=128, experts_per_tok=1, moe_every=2, shared_expert=True)


@register("minitron-8b")
def minitron():
    """[dense] pruned nemotron [arXiv:2407.14679; hf]"""
    return ModelConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
        vocab_size=256000, head_dim=128)


@register("internlm2-20b")
def internlm2():
    """[dense] GQA [arXiv:2403.17297; hf]"""
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
        vocab_size=92544, head_dim=128)


@register("qwen3-32b")
def qwen3():
    """[dense] qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]"""
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
        vocab_size=151936, head_dim=128, qk_norm=True)


@register("command-r-35b")
def command_r():
    """[dense] GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
        vocab_size=256000, head_dim=128)


@register("llama-3.2-vision-11b")
def llama32_vision():
    """[vlm] cross-attn image layers every 5th layer; patch embeddings are a
    stub frontend input. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=128256, head_dim=128,
        cross_attn_every=5, n_image_tokens=1600)


@register("zamba2-7b")
def zamba2():
    """[hybrid] Mamba2 backbone + shared attention block.
    [arXiv:2411.15242; unverified]"""
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
        vocab_size=32000, head_dim=112,
        ssm_state=64, ssm_head_dim=64, shared_attn_every=6)


@register("whisper-base")
def whisper_base():
    """[audio] enc-dec; conv frontend STUB (precomputed frame embeddings).
    [arXiv:2212.04356; unverified]"""
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=51865, head_dim=64,
        n_audio_frames=1500, rope_theta=10000.0)


@register("mamba2-130m")
def mamba2_130m():
    """[ssm] SSD (state-space duality), attention-free.
    [arXiv:2405.21060; unverified]"""
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=50280, ssm_state=128, ssm_head_dim=64)


@register("vgg16")
def vgg16():
    """The paper's case-study CNN (Sec. 6.1) — runs on the hybrid engine."""
    return ModelConfig(name="vgg16", family="cnn", vocab_size=1000)
