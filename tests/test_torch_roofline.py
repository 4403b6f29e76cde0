"""The port's roofline counter (``launch/roofline.py``) on the CPU.

Forward + gradient FLOPs of reduced configs (fp32, batch 2, fake tensors)
against the reference's ``analyze_hlo`` of the compiled
``value_and_grad``: equal (rel 1e-9) where no loop is nested in the layer
loop (dense, MoE and the VLM at 64 tokens). Where one is (the scan
attention at 2048 tokens, the SSD's chunk recurrence), the port counts
every iteration and equals the analytic count of the matmuls that run,
while the reference's one trip count for every ``while`` body falls short;
it over-counts whisper's encoder, whose loop takes the decoder's trip
count (ROADMAP Queue 3). The analytic count: each forward matmul once, its two
gradient products, and the remat recompute of every unit's matmuls but
its last (non-reentrant checkpointing stops recomputing once the last
saved input is rebuilt, and no backward needs the last product's output).

Bytes of one matmul and one elementwise op; K6's declared work counted
once in a ``hopper`` prefill on the CPU (its plain version uncounted); the
roofline terms under the H100's constants.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.launch import roofline as r_roofline  # noqa: E402
from repro.models.transformer import group_period  # noqa: E402
from repro.train import steps as r_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    attended_pairs,
    flash_attention_kernel,
    flash_attention_work,
)
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.models.layers import LONG_SEQ  # noqa: E402
from repro_torch.train import steps  # noqa: E402

B = 2


def _batch(cfg, seq, make):
    batch = {"tokens": make((B, seq), torch.int32),
             "targets": make((B, seq), torch.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = make((B, cfg.n_image_tokens, cfg.d_model),
                                     torch.float32)
    if cfg.family == "audio":
        batch["frames"] = make((B, cfg.n_audio_frames, cfg.d_model),
                               torch.float32)
    return batch


def _port_flops(arch: str, seq: int) -> float:
    cfg = get_config(arch).reduced()
    with FakeTensorMode():
        params = steps.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        batch = _batch(cfg, seq, lambda s, d: torch.zeros(s, dtype=d))
        _, st = rl.count(steps.loss_and_grads, params, batch, cfg)
    return st.flops


def _reference_flops(arch: str, seq: int) -> float:
    """``analyze_hlo`` of the reference's compiled forward + gradient, at
    the reference dry-run's trip count (``dryrun.trip_count``, which is
    not imported here: importing that module pins 512 host devices)."""
    cfg = r_get_config(arch).reduced()
    params = jax.eval_shape(
        lambda: r_steps.init_params(jax.random.PRNGKey(0), cfg))
    sds = {"tokens": jax.ShapeDtypeStruct((B, seq), jnp.int32),
           "targets": jax.ShapeDtypeStruct((B, seq), jnp.int32)}
    if cfg.family == "vlm":
        sds["image_embeds"] = jax.ShapeDtypeStruct(
            (B, cfg.n_image_tokens, cfg.d_model), jnp.float32)
    if cfg.family == "audio":
        sds["frames"] = jax.ShapeDtypeStruct(
            (B, cfg.n_audio_frames, cfg.d_model), jnp.float32)

    def loss(p, b):
        return r_steps.cross_entropy(r_steps.forward_logits(p, b, cfg),
                                     b["targets"])
    text = jax.jit(jax.value_and_grad(loss)).lower(
        params, sds).compile().as_text()
    trip = {"ssm": cfg.n_layers,
            "hybrid": max(1, cfg.n_layers // max(1, cfg.shared_attn_every))
            }.get(cfg.family, cfg.n_layers // group_period(cfg))
    return r_roofline.analyze_hlo(text, trip_count=trip).flops


# ---------------------------------------------------------------------------
# the analytic count
# ---------------------------------------------------------------------------

def _mm(m, k, n):
    return 2 * m * k * n


def _attention(cfg, seq, kv_seq=None):
    """Self-attention over ``seq`` tokens, or cross-attention to
    ``kv_seq`` states."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    skv = kv_seq or seq
    # the scan runs every KV block of 1024 (the last padded) for every query
    padded = math.ceil(skv / 1024) * 1024 if seq >= LONG_SEQ else skv
    core = 2 * B * h * seq * padded * hd
    return [_mm(B * seq, d, h * hd), _mm(B * skv, d, kv * hd),
            _mm(B * skv, d, kv * hd), core, core, _mm(B * seq, h * hd, d)]


def _swiglu(cfg, seq):
    t = B * seq
    return [_mm(t, cfg.d_model, cfg.d_ff)] * 2 + [_mm(t, cfg.d_ff,
                                                      cfg.d_model)]


def _mamba(cfg, seq):
    """in_proj, the chunked SSD's five products (chunks of 64), out_proj."""
    t, d, di = B * seq, cfg.d_model, cfg.d_ssm
    n, h, p = cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    q = min(64, seq)
    nc = math.ceil(seq / q)
    return [_mm(t, d, 2 * di + 2 * n + h),
            2 * B * nc * q * q * n,            # C B^T
            2 * B * nc * h * q * q * p,        # (W) x, within chunks
            2 * B * nc * h * n * p * q,        # chunk-final states
            2 * B * h * nc * nc * n * p,       # the chunk recurrence
            2 * B * nc * h * q * n * p,        # C S_prev
            _mm(t, di, d)]


def _gelu_mlp(cfg, seq):
    return [_mm(B * seq, cfg.d_model, cfg.d_ff),
            _mm(B * seq, cfg.d_ff, cfg.d_model)]


def _analytic(arch: str, seq: int) -> int:
    cfg = get_config(arch).reduced()
    head = _mm(B * seq, cfg.d_model, cfg.vocab_size)
    if cfg.family == "audio":
        # the encoder over the frames (no remat), the decoder layers
        # (self- and cross-attention, remat)
        frames = cfg.n_audio_frames
        enc = _attention(cfg, frames) + _gelu_mlp(cfg, frames)
        dec = (_attention(cfg, seq) + _attention(cfg, seq, frames)
               + _gelu_mlp(cfg, seq))
        return (cfg.encoder_layers * 3 * sum(enc)
                + cfg.n_layers * (3 * sum(dec) + sum(dec[:-1])) + 3 * head)
    if cfg.family == "ssm":
        units = [_mamba(cfg, seq)] * cfg.n_layers
    elif cfg.family == "hybrid":
        per = cfg.shared_attn_every
        units = [_mamba(cfg, seq) * per + _attention(cfg, seq)
                 + _swiglu(cfg, seq)] * (cfg.n_layers // per)
    else:
        units = [_attention(cfg, seq) + _swiglu(cfg, seq)] * cfg.n_layers
    assert cfg.remat
    return sum(3 * sum(u) + sum(u[:-1]) for u in units) + 3 * head


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minitron-8b", "qwen3-32b",
                                  "llama4-scout-17b-16e",
                                  "llama-3.2-vision-11b"])
def test_flops_equal_the_reference_where_no_loop_is_nested(arch):
    port, ref = _port_flops(arch, 64), _reference_flops(arch, 64)
    assert abs(port - ref) <= 1e-9 * ref, (port, ref)
    if arch in ("minitron-8b", "qwen3-32b"):
        assert port == _analytic(arch, 64)


@pytest.mark.parametrize("arch,seq,ratio", [
    ("minitron-8b", LONG_SEQ, 1.762),   # the scan's KV blocks
    ("mamba2-130m", 64, 1.035),         # the SSD
    ("zamba2-7b", 64, 1.023),
    ("whisper-base", 64, 0.909),        # the encoder's 2-layer loop
])
def test_every_loop_counts_its_own_iterations(arch, seq, ratio):
    """The port equals the analytic count. The reference's differs by the
    ratio ROADMAP Queue 3 records: a loop nested in the layer loop counts
    one trip per layer (short), and whisper's encoder loop takes the
    decoder's trip count (4 for its 2 layers: over)."""
    port = _port_flops(arch, seq)
    assert port == _analytic(arch, seq)
    ref = _reference_flops(arch, seq)
    assert round(port / ref, 3) == ratio, port / ref


def test_bytes_of_one_matmul_and_one_elementwise_op():
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    _, st = rl.count(torch.mm, a, b)
    assert st.flops == 2 * 64 * 32 * 16
    assert st.bytes_accessed == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    _, st = rl.count(torch.add, a, a)
    assert st.flops == 0 and st.bytes_accessed == 3 * 4 * 64 * 32
    # views and allocations move nothing; an overwrite reads only its source
    _, st = rl.count(lambda: (a.view(32, 64), torch.empty(5),
                              a.t().contiguous()))
    assert st.bytes_accessed == 2 * 4 * 64 * 32
    dst = torch.empty(64, 32)
    _, st = rl.count(dst.copy_, a)
    assert st.bytes_accessed == 2 * 4 * 64 * 32
    assert st.peak_live_bytes == 0


def test_peak_live_bytes_follows_what_is_alive():
    def run():
        x = torch.ones(1000)          # 4000 bytes
        y = x + 1                     # 8000 alive
        del x
        return y * 2                  # y and the result: 8000 again
    _, st = rl.count(run)
    assert st.peak_live_bytes == 8000


def test_k6_declared_work_is_counted_once_on_the_cpu():
    """The kernel wrapper on CPU tensors: exactly the declared work, none
    of its plain version's aten ops."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(6, 96, 16, generator=g)
    k = torch.randn(3, 112, 16, generator=g)
    v = torch.randn(3, 112, 16, generator=g)
    before = dict(common.LAUNCHES)
    _, st = rl.count(flash_attention_kernel, q, k, v, causal=True,
                     row_offset=16)
    flops, nbytes = flash_attention_work(6, 3, 96, 112, 16, causal=True,
                                         kv_len=112, row_offset=16,
                                         itemsize=4)
    assert (st.flops, st.bytes_accessed) == (flops, nbytes)
    assert st.kernels == {"flash_attention": {"launches": 1, "flops": flops,
                                              "bytes": nbytes}}
    assert common.LAUNCHES == before       # a plain version is no launch


@pytest.mark.parametrize("sq,kv_len,off", [(96, 112, 16), (7, 5, 0),
                                           (64, 200, 300), (1, 9, 8)])
def test_attended_pairs_is_the_mask_count(sq, kv_len, off):
    rows = off + np.arange(sq)[:, None]
    cols = np.arange(kv_len)[None, :]
    assert attended_pairs(sq, kv_len, True, off) == int((cols <= rows).sum())
    assert attended_pairs(sq, kv_len, False, off) == sq * kv_len


def test_hopper_prefill_counts_k6_work_not_its_plain_version():
    """A reduced minitron-8b prefill of 2048 tokens on the CPU: ``hopper``
    counts one K6 launch a layer at its declared work and none of the
    plain version's products; its other FLOPs are the ``torch`` backend's
    less the scan's products."""
    cfg = get_config("minitron-8b").reduced()
    seq = LONG_SEQ
    counts = {}
    with FakeTensorMode():
        params = steps.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        tokens = torch.zeros((B, seq), dtype=torch.int32)
        for backend in ("torch", "hopper"):
            prefill, _ = steps.make_serve_steps(cfg, backend=backend)
            cache = steps.init_cache(cfg, B, seq, "cpu")
            _, counts[backend] = rl.count(prefill, params, tokens, cache)
    k6 = counts["hopper"].kernels["flash_attention"]
    flops, nbytes = flash_attention_work(
        B * cfg.n_heads, B * cfg.n_kv_heads, seq, seq, cfg.head_dim,
        causal=True, kv_len=seq, row_offset=0, itemsize=4)
    assert k6 == {"launches": cfg.n_layers, "flops": cfg.n_layers * flops,
                  "bytes": cfg.n_layers * nbytes}
    scan = cfg.n_layers * sum(_attention(cfg, seq)[3:5])
    assert (counts["hopper"].flops - k6["flops"]
            == counts["torch"].flops - scan)
    assert "flash_attention" not in counts["torch"].kernels


def test_roofline_terms_under_the_h100_constants():
    st = rl.StepStats(flops=2 * 989e12, bytes_accessed=2 * 3.35e12,
                      collective_bytes=4 * 450e9)
    roof = rl.roofline_from_stats(st, n_chips=2)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == (
        pytest.approx(1.0), pytest.approx(1.0), pytest.approx(2.0))
    assert roof.bound == "collective" and roof.step_time_s == roof.collective_s
    fp32 = rl.roofline_from_stats(st, dtype=torch.float32)
    assert fp32.compute_s == pytest.approx(2 * 989e12 / 67e12)
    assert fp32.bound == "compute"
    assert rl.peak_flops(torch.int8) == 1979e12
    cfg = dataclasses.replace(get_config("minitron-8b"), n_layers=4)
    assert rl.model_flops(cfg, "train", 10) == 60 * cfg.active_param_count()
    with pytest.raises(ValueError, match="unknown collective"):
        rl.declare_collective("gather", 1.0)


def test_compressed_psum_declares_its_all_reduces(tmp_path):
    """``optim/compression.compressed_psum`` in a one-process ``gloo``
    world: two all-reduces a leaf (the amax and the int32 payload)."""
    import torch.distributed as dist

    from repro_torch.optim.compression import (
        compressed_psum,
        init_error_state,
    )
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        grads = {"w": torch.ones(3, 5), "b": torch.ones(7)}
        (mean, _), st = rl.count(compressed_psum, grads,
                                 init_error_state(grads))
    finally:
        dist.destroy_process_group()
    assert torch.allclose(mean["w"], grads["w"], rtol=0.02)
    assert st.collective_counts == {"all-reduce": 4}
    assert st.collective_bytes == 2 * 4 + 4 * (15 + 7)
