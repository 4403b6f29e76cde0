"""The port's SSD (mamba2) modules, GELU MLP and cross-attention against
the reference's, module by module.

SSD: ``ssd_chunked`` at chunks 8 and 64 over L = 40 (not a multiple of
the chunk), with and without an initial state, ``ssd_reference``,
``ssd_decode_step``, ``_segsum``, ``_causal_conv`` with and without a
state and ``mamba_block`` (no cache, a prefill carrying a non-zero cache,
a decode step), all within 2e-4, the reference's own chunked-vs-sequential
tolerance (``tests/test_ssd.py``); in bf16 the block keeps the
reference's dtypes (float32 state, activations in bf16). ``mlp`` within
1e-4, which holds its tanh-approximated GELU. ``attention`` with
``xattn_kv`` (encoder or image states): K/V from them, no RoPE, no causal
mask even with the default ``causal=True``, on the short branch and at
2048 queries (K6's plain version under ``hopper``, the scan under
``torch``), and ``use_rope=False`` self-attention.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import mamba2 as r_mamba2  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers, mamba2  # noqa: E402

TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _near(out, ref, tol=TOL):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _ssd_inputs(l=40, b=2, h=3, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bb = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((b, l, n)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, p)) * 0.2).astype(np.float32)
    return (x, dt, a, bb, c), s0


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("chunk", [8, 64])
def test_ssd_chunked_matches_reference(chunk, initial):
    args, s0 = _ssd_inputs()
    s0 = s0 if initial else None
    ry, rs = r_mamba2.ssd_chunked(*map(_j, args), chunk=chunk,
                                  initial_state=None if s0 is None
                                  else _j(s0))
    y, s = mamba2.ssd_chunked(*map(_t, args), chunk=chunk,
                              initial_state=None if s0 is None else _t(s0))
    _near(y, ry)
    _near(s, rs)
    # and the sequential oracles agree with both
    qy, qs = mamba2.ssd_reference(*map(_t, args),
                                  initial_state=None if s0 is None
                                  else _t(s0))
    _near(qy, ry)
    _near(qs, rs)


def test_ssd_decode_step_and_segsum_match_reference():
    (x, dt, a, b, c), s0 = _ssd_inputs(l=1)
    ry, rs = r_mamba2.ssd_decode_step(_j(s0), _j(x[:, 0]), _j(dt[:, 0]),
                                      _j(a), _j(b[:, 0]), _j(c[:, 0]))
    y, s = mamba2.ssd_decode_step(_t(s0), _t(x[:, 0]), _t(dt[:, 0]), _t(a),
                                  _t(b[:, 0]), _t(c[:, 0]))
    _near(y, ry)
    _near(s, rs)
    seg = np.random.default_rng(3).standard_normal((2, 3, 9)).astype(
        np.float32)
    out, ref = mamba2._segsum(_t(seg)).numpy(), np.asarray(
        r_mamba2._segsum(_j(seg)))
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = (rng.standard_normal((4, 6)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(6) * 0.1).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    ro, rs = r_mamba2._causal_conv(_j(u), _j(w), _j(b),
                                   _j(st) if with_state else None)
    o, s = mamba2._causal_conv(_t(u), _t(w), _t(b),
                               _t(st) if with_state else None)
    _near(o, ro, 1e-5)
    _near(s, rs, 1e-5)


# ---------------------------------------------------------------------------
# the mamba2 block
# ---------------------------------------------------------------------------

def _block_params(cfg, seed):
    """A mamba block's leaves, every one drawn (the reference's zeros and
    ones too)."""
    rng = np.random.default_rng(seed)
    d, di, n, h = cfg.d_model, cfg.d_ssm, cfg.ssm_state, cfg.n_ssm_heads
    conv = di + 2 * n
    draw = lambda *s, scale=1.0, base=0.0: (
        base + scale * rng.standard_normal(s)).astype(np.float32)
    return {"norm": draw(d, scale=0.3, base=1.0),
            "in_proj": draw(d, 2 * di + 2 * n + h, scale=d ** -0.5),
            "conv_w": draw(cfg.ssm_conv, conv, scale=0.5),
            "conv_b": draw(conv, scale=0.3),
            "A_log": draw(h, scale=0.3), "D": draw(h, scale=0.3, base=1.0),
            "dt_bias": draw(h, scale=0.3),
            "norm2": draw(di, scale=0.3, base=1.0),
            "out_proj": draw(di, d, scale=di ** -0.5)}


@pytest.mark.parametrize("mode", ["forward", "prefill", "decode"])
def test_mamba_block_matches_reference(mode):
    """No cache; a 40-token prefill carrying a non-zero conv and SSM cache
    into the block; a one-token decode step from that cache."""
    r_cfg, cfg = (f("mamba2-130m").reduced() for f in (r_get_config,
                                                       get_config))
    p = _block_params(cfg, 5)
    rng = np.random.default_rng(6)
    l = 1 if mode == "decode" else 40
    x = rng.standard_normal((2, l, cfg.d_model)).astype(np.float32)
    cache = None
    if mode != "forward":
        conv = cfg.d_ssm + 2 * cfg.ssm_state
        cache = {"conv": rng.standard_normal(
                     (2, cfg.ssm_conv - 1, conv)).astype(np.float32),
                 "ssm": (0.3 * rng.standard_normal(
                     (2, cfg.n_ssm_heads, cfg.ssm_state,
                      cfg.ssm_head_dim))).astype(np.float32)}
    ry, rc = r_mamba2.mamba_block(
        jax.tree.map(_j, p), _j(x), r_cfg, ssm_cache=None if cache is None
        else jax.tree.map(_j, cache), chunk=16)
    (y,), (c,) = mamba2.mamba_block(
        [{k: _t(v) for k, v in p.items()}], [_t(x)], cfg,
        ssm_cache=None if cache is None
        else [{k: _t(v) for k, v in cache.items()}], chunk=16)
    _near(y, ry)
    if cache is None:
        assert c is None and rc is None
    else:
        _near(c["conv"], rc["conv"])
        _near(c["ssm"], rc["ssm"])


def test_mamba_block_keeps_the_reference_dtypes_in_bf16():
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              dtype="bfloat16")
    p = {k: _t(v).to(torch.float32 if k in layers.FP32_LEAVES
                     else torch.bfloat16)
         for k, v in _block_params(cfg, 7).items()}
    x = torch.randn(2, 40, cfg.d_model).to(torch.bfloat16)
    cache = mamba2.init_ssm_cache(cfg, 2, "cpu")
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    (y,), (c,) = mamba2.mamba_block([p], [x], cfg, ssm_cache=[{
        "conv": cache["conv"][0], "ssm": cache["ssm"][0]}])
    assert y.dtype == torch.bfloat16 and c["ssm"].dtype == torch.float32
    assert c["conv"].dtype == torch.bfloat16
    (y1,), (c1,) = mamba2.mamba_block([p], [x[:, :1]], cfg, ssm_cache=[c])
    assert y1.dtype == torch.bfloat16 and c1["ssm"].dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(y1.float()).all()


# ---------------------------------------------------------------------------
# the GELU MLP and cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["random", "identity"])
def test_mlp_matches_reference(weights):
    """Identity weights make the MLP the GELU itself over [-6, 6], where
    the exact erf GELU differs from the tanh form by up to 4.7e-4."""
    rng = np.random.default_rng(8)
    d = f = 64
    if weights == "identity":
        p = {"w_in": np.eye(d), "w_out": np.eye(d), "b_in": np.zeros(f),
             "b_out": np.zeros(d)}
        x = np.linspace(-6, 6, 4 * d).reshape(1, 4, d)
    else:
        f = 128
        p = {"w_in": rng.standard_normal((d, f)) * d ** -0.5,
             "w_out": rng.standard_normal((f, d)) * f ** -0.5,
             "b_in": rng.standard_normal(f) * 0.3,
             "b_out": rng.standard_normal(d) * 0.3}
        x = rng.standard_normal((2, 5, d)) * 2
    ref = r_layers.mlp(jax.tree.map(_j, p), _j(x))
    out = layers.mlp({k: _t(v) for k, v in p.items()}, _t(x))
    _near(out, ref, 1e-4)
    if weights == "identity":           # the exact GELU would not pass
        exact = torch.nn.functional.gelu(_t(x))
        assert float((exact - _t(ref)).abs().max()) > 1e-4


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("s", [8, 2048])
def test_cross_attention_matches_reference(s, backend):
    """``xattn_kv`` of 24 states with the default ``causal=True``: no mask,
    no RoPE (the reference's ``causal and xattn_kv is None``)."""
    r_cfg, cfg = (f("llama-3.2-vision-11b").reduced() for f in
                  (r_get_config, get_config))
    rng = np.random.default_rng(s)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     r_layers.init_attention(jax.random.PRNGKey(2), r_cfg,
                                             jnp.float32))
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = (7 + np.arange(s, dtype=np.int32))[None]
    ref, _ = r_layers.attention(jax.tree.map(_j, p), _j(x), r_cfg,
                                positions=jnp.asarray(pos), xattn_kv=_j(kv))
    out, _ = layers.attention({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                              positions=torch.from_numpy(pos),
                              xattn_kv=_t(kv), backend=backend)
    _near(out, ref, 1e-4)


def test_self_attention_without_rope_matches_reference():
    """Whisper's self-attention: ``use_rope=False`` over a KV cache."""
    r_cfg, cfg = (f("whisper-base").reduced() for f in (r_get_config,
                                                        get_config))
    rng = np.random.default_rng(9)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     r_layers.init_attention(jax.random.PRNGKey(3), r_cfg,
                                             jnp.float32))
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 16, cfg.n_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    ref, rc = r_layers.attention(jax.tree.map(_j, p), _j(x), r_cfg,
                                 kv_cache={"k": _j(ck), "v": _j(cv)},
                                 cache_pos=5, use_rope=False)
    cache = {"k": _t(ck.copy()), "v": _t(cv.copy())}
    out, cache = layers.attention({k: _t(v) for k, v in p.items()}, _t(x),
                                  cfg, kv_cache=cache, cache_pos=5,
                                  use_rope=False)
    _near(out, ref, 1e-4)
    _near(cache["k"], rc["k"], 1e-5)
