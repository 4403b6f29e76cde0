"""The port's LM serving path (dense family) against the reference.

Reduced minitron-8b in fp32 with the reference's own parameters carried
across (``params_from_numpy``): prefill logits for a 32-token prompt (the
einsum branch) and a 2048-token prompt (the long-sequence branch: K6's
plain version under ``backend="hopper"``, the scan port under
``backend="torch"``), then 4 decode steps teacher-forced with the
reference's greedy tokens, all within ``1e-4 * max(1, max|ref|)``. The
scan port against the reference's scan (``rtol=atol=2e-4``), and the
configuration registry field for field.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.configs.base import list_archs as r_list_archs  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import transformer as r_transformer  # noqa: E402
from repro.train import steps as r_steps  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.train import steps  # noqa: E402

BATCH, N_DECODE = 2, 4
ARCH = "minitron-8b"


def _close(out, ref, rel=1e-4):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert out.shape == ref.shape and err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_lists_the_reference_archs():
    assert list_archs() == r_list_archs()


@pytest.mark.parametrize("arch", r_list_archs())
def test_config_equals_reference_field_for_field(arch):
    ref, cfg = r_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.torch_dtype == getattr(torch, str(ref.jnp_dtype))


def test_minitron_is_about_ten_billion_parameters_in_bf16():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (32, 4096, 32, 8, 128, 256000)
    assert cfg.torch_dtype == torch.bfloat16
    assert 9.5e9 < cfg.param_count() < 1.0e10
    with pytest.raises(ValueError, match="dtype"):
        dataclasses.replace(cfg, dtype="bf17").torch_dtype


# ---------------------------------------------------------------------------
# the scan against the reference (K6's cases are in test_torch_kernels.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("row_offset", [0, 7])
def test_scan_matches_reference_scan(causal, row_offset):
    rng = np.random.default_rng(5 + row_offset)
    b, s, g, r, d, skv = 2, 24, 2, 2, 16, 37
    qg = rng.standard_normal((b, s, g, r, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, g, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, g, d)).astype(np.float32)
    ref = r_layers._flash_attention_scan(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), causal=causal,
        row_offset=row_offset, block=16)
    out = layers._flash_attention_scan(
        torch.from_numpy(qg), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, row_offset=row_offset, block=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 2100, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(2100, dtype=np.int32)[None, :] + np.array([[0], [5]])
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           r_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0),
           r_layers.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0),
           rel=1e-5)


@pytest.mark.parametrize("backend", ["hopper", "torch"])
@pytest.mark.parametrize("cache_pos", [5, 2048])
def test_hopper_long_attention_past_position_0_matches_reference(
        monkeypatch, cache_pos, backend):
    """A causal chunk of 2048 queries written into a filled cache at
    ``cache_pos`` (chunked prefill, or a long suffix appended to a cache):
    ``hopper`` runs K6 (its plain version here) with the row offset,
    ``torch`` the scan; both against the reference's attention with the
    same cache, in fp32 (where the scan's bf16 rounding of P is a no-op)."""
    r_cfg, cfg = r_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    rng = np.random.default_rng(cache_pos)
    s, kv, hd = layers.LONG_SEQ, cfg.n_kv_heads, cfg.head_dim
    np_p = jax.tree.map(lambda a: np.array(a, np.float32),
                        r_layers.init_attention(jax.random.PRNGKey(1), r_cfg,
                                                jnp.float32))
    x = rng.standard_normal((1, s, cfg.d_model)).astype(np.float32)
    pos = (cache_pos + np.arange(s, dtype=np.int32))[None]
    ck, cv = (rng.standard_normal((1, cache_pos + s + 8, kv, hd))
              .astype(np.float32) for _ in range(2))
    ref, ref_cache = r_layers.attention(
        jax.tree.map(jnp.asarray, np_p), jnp.asarray(x), r_cfg,
        positions=jnp.asarray(pos),
        kv_cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        cache_pos=cache_pos)
    k6 = _counting(monkeypatch, "flash_attention")
    p = {name: torch.from_numpy(a) for name, a in np_p.items()}
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy())}
    out, cache = layers.attention(p, torch.from_numpy(x), cfg,
                                  positions=torch.from_numpy(pos),
                                  kv_cache=cache, cache_pos=cache_pos,
                                  backend=backend)
    assert len(k6) == (1 if backend == "hopper" else 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="unknown backend"):
        layers.attention(p, torch.from_numpy(x[:, :4]), cfg,
                         backend="pallas")


# ---------------------------------------------------------------------------
# the whole serving path against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_ref():
    """The reference's reduced minitron-8b served once per prompt length:
    prompts, its greedy tokens and its logits at prefill and each decode
    step, plus its parameters as float32 numpy."""
    cfg = r_get_config(ARCH).reduced()
    params = r_steps.init_params(jax.random.PRNGKey(0), cfg)
    prefill, decode = r_steps.make_serve_steps(cfg)
    prefill, decode = jax.jit(prefill), jax.jit(decode)
    runs = {}
    for prompt_len in (32, 2048):
        rng = np.random.default_rng(prompt_len)
        prompts = rng.integers(0, cfg.vocab_size, (BATCH, prompt_len),
                               dtype=np.int32)
        cache = r_steps.init_cache(cfg, BATCH, prompt_len + N_DECODE)
        logits, cache = prefill(params, jnp.asarray(prompts), cache)
        all_logits, toks = [np.asarray(logits)], []
        for i in range(N_DECODE):
            tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
            toks.append(tok)
            logits, cache = decode(params, jnp.asarray(tok), cache,
                                   jnp.int32(prompt_len + i))
            all_logits.append(np.asarray(logits))
        runs[prompt_len] = (prompts, toks, all_logits)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return np_params, runs


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(layers, name)

    def wrapped(*args, **kwargs):
        calls.append(args[0].shape)
        return fn(*args, **kwargs)
    monkeypatch.setattr(layers, name, wrapped)
    return calls


@pytest.mark.parametrize("prompt_len", [32, 2048])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_serving_matches_reference(lm_ref, monkeypatch, prompt_len, backend):
    np_params, runs = lm_ref
    cfg = get_config(ARCH).reduced()
    params = transformer.params_from_numpy(np_params, cfg, "cpu")
    k6 = _counting(monkeypatch, "flash_attention")
    scan = _counting(monkeypatch, "_flash_attention_scan")
    prefill, decode = steps.make_serve_steps(cfg, backend=backend)
    prompts, toks, ref_logits = runs[prompt_len]
    cache = steps.init_cache(cfg, BATCH, prompt_len + N_DECODE, "cpu")
    common.reset_launches()
    logits, cache = prefill(params, torch.from_numpy(prompts), cache)
    _close(logits, ref_logits[0])
    long = prompt_len >= layers.LONG_SEQ
    assert len(k6) == (cfg.n_layers if long and backend == "hopper" else 0)
    assert len(scan) == (cfg.n_layers if long and backend == "torch" else 0)
    for i, tok in enumerate(toks):
        logits, cache = decode(params, torch.from_numpy(tok), cache,
                               prompt_len + i)
        _close(logits, ref_logits[i + 1])
    assert len(k6) + len(scan) == (cfg.n_layers if long else 0)
    assert common.LAUNCHES == dict.fromkeys(common.KERNELS, 0)  # CPU: plain


def test_forward_matches_reference(lm_ref):
    np_params, _ = lm_ref
    r_cfg, cfg = r_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 24),
                                               dtype=np.int32)
    ref = r_transformer.forward(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens), r_cfg)
    params = transformer.params_from_numpy(np_params, cfg, "cpu")
    with torch.no_grad():
        _close(transformer.forward(params, torch.from_numpy(tokens), cfg),
               ref)


def test_init_params_has_the_reference_tree_and_scales():
    r_cfg, cfg = r_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    ref = jax.eval_shape(lambda k: r_steps.init_params(k, r_cfg),
                         jax.random.PRNGKey(0))
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert transformer._tree_map(lambda t: tuple(t.shape), params) == shapes
    wq = params["layers"][0]["attn"]["wq"]
    assert wq.dtype == torch.float32 and wq.shape[0] == cfg.n_layers
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(params["embed"].std()) - 1.0) < 0.05
    assert not torch.equal(wq[0], wq[1])    # each group draws its own
    bf16 = transformer.params_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), ref),
        dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    assert bf16["lm_head"].dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32"):
        transformer.params_from_numpy({"w": np.zeros(2, np.float64)}, cfg,
                                      "cpu")


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_serve_entry_point_on_cpu(backend, capsys):
    out = serve_mod.serve(ARCH, reduced=True, batch=2, prompt_len=8, gen=3,
                          backend=backend, device="cpu")
    assert out.tokens.shape == (2, 3)
    assert out.prefill_logits.shape == (2, 512)
    assert torch.isfinite(out.prefill_logits).all()
    assert out.build_ms is not None and out.prefill_ms > 0
    again = serve_mod.serve(ARCH, reduced=True, batch=2, prompt_len=8, gen=3,
                            backend=backend, device="cpu")
    np.testing.assert_array_equal(again.tokens, out.tokens)   # seeded
    assert "prefill 8 toks x2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="CNN"):
        serve_mod.serve("vgg16", device="cpu")


def test_serving_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    cfg = get_config(ARCH).reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.serve(ARCH)
