"""The port's SSM, hybrid, audio, VLM and MoE serving paths against the
reference.

Reduced mamba2-130m, zamba2-7b (also with 5 layers, so a tail of mamba
layers runs without the shared block), whisper-base,
llama-3.2-vision-11b, llama4-scout-17b-16e (an MoE FFN on every layer)
and llama4-maverick-400b-a17b (on alternating layers) in fp32. Every parameter leaf is drawn from a seeded
numpy generator, the ones the reference initializes to zeros or ones too
(biases, ``xattn_gate``, ``A_log``, ``dt_bias``, ``D``, norms), so no term
can be wrong unseen, and the same tree goes to both packages
(``params_from_numpy``). Per case and port backend: ``forward_logits``,
then ``prefill``, then 4 decode steps teacher-forced with the reference's
greedy tokens, then a second prefill into the used cache (zamba2 zeroes
its SSM states first, mamba2 carries them in), each within
``2e-4 * max(1, max|logit|)`` of the reference's. zamba2 and the VLM also
run a 2048-token prompt, where the ``hopper`` backend runs K6's plain
version (the VLM's cross-attention non-causal) and ``torch`` the scan; so
does scout, whose prefill routes 4096 tokens a layer with capacity drops.
Then the serve entry point on reduced whisper, VLM and scout with the
reference's own parameters: the same greedy
tokens as the reference's ``serve``, which holds the order in which the
frames or image embeddings and the prompts are drawn from the seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.models import whisper as r_whisper  # noqa: E402
from repro.train import steps as r_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import layers, whisper  # noqa: E402
from repro_torch.train import steps  # noqa: E402

BATCH, N_DECODE, REL = 2, 4, 2e-4

# (id, arch, n_layers override, prompt length)
CASES = [
    ("mamba2", "mamba2-130m", None, 100),
    ("zamba2", "zamba2-7b", None, 32),
    ("zamba2_tail", "zamba2-7b", 5, 32),
    ("zamba2_2048", "zamba2-7b", None, 2048),
    ("whisper", "whisper-base", None, 32),
    ("vision", "llama-3.2-vision-11b", None, 32),
    ("vision_2048", "llama-3.2-vision-11b", None, 2048),
    ("scout", "llama4-scout-17b-16e", None, 32),
    ("scout_2048", "llama4-scout-17b-16e", None, 2048),
    ("maverick", "llama4-maverick-400b-a17b", None, 32),
]


def _close(out, ref, rel=REL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert out.shape == ref.shape and err <= tol, (err, tol)


def _cfgs(arch, n_layers):
    r_cfg, cfg = r_get_config(arch).reduced(), get_config(arch).reduced()
    if n_layers is not None:
        r_cfg = dataclasses.replace(r_cfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return r_cfg, cfg


def _drawn_params(r_cfg, seed):
    """The reference's tree with every leaf drawn anew from numpy: a leaf
    the reference initializes to a constant (zeros, ones) becomes that
    constant plus 0.3 N(0, 1), any other keeps its init's spread."""
    rng = np.random.default_rng(seed)
    init = r_steps.init_params(jax.random.PRNGKey(seed), r_cfg)

    def draw(a):
        a = np.asarray(a, np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if np.all(a == a.flat[0]):
            return a.flat[0] + 0.3 * noise
        return noise * a.std()
    return jax.tree.map(draw, init)


def _extras_np(cfg, rng):
    if cfg.family == "vlm":
        return {"image_embeds": rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (BATCH, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)}
    return {}


_REF_RUNS = {}


def _reference(case):
    """The reference run of one case, once per module: the drawn params,
    the inputs, its forward logits and its prefill and decode logits with
    its greedy tokens."""
    if case in _REF_RUNS:
        return _REF_RUNS[case]
    _, arch, n_layers, prompt_len = next(c for c in CASES if c[0] == case)
    r_cfg, _ = _cfgs(arch, n_layers)
    np_params = _drawn_params(r_cfg, seed=len(case))
    params = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(prompt_len)
    prompts = rng.integers(0, r_cfg.vocab_size, (BATCH, prompt_len),
                           dtype=np.int32)
    ex = _extras_np(r_cfg, rng)
    batch = {"tokens": jnp.asarray(prompts),
             **{k: jnp.asarray(v) for k, v in ex.items()}}
    fwd = np.asarray(jax.jit(
        lambda p, b: r_steps.forward_logits(p, b, r_cfg))(params, batch))
    extras = {}
    if "image_embeds" in ex:
        extras["image_embeds"] = batch["image_embeds"]
    if "frames" in ex:
        extras["enc_out"] = r_whisper.encode(params, batch["frames"], r_cfg)
    prefill, decode = (jax.jit(f) for f in r_steps.make_serve_steps(r_cfg))
    cache = r_steps.init_cache(r_cfg, BATCH, prompt_len + N_DECODE)
    logits, cache = prefill(params, batch["tokens"], cache, extras)
    all_logits, toks = [np.asarray(logits)], []
    for i in range(N_DECODE):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        toks.append(tok)
        logits, cache = decode(params, jnp.asarray(tok), cache,
                               jnp.int32(prompt_len + i), extras)
        all_logits.append(np.asarray(logits))
    # a second prefill into the used cache: zamba2 zeroes its SSM states
    # first, mamba2 carries them in
    again, _ = prefill(params, batch["tokens"], cache, extras)
    all_logits.append(np.asarray(again))
    _REF_RUNS[case] = (np_params, prompts, ex, fwd, toks, all_logits)
    return _REF_RUNS[case]


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(layers, name)

    def wrapped(*args, **kwargs):
        calls.append(kwargs.get("causal"))
        return fn(*args, **kwargs)
    monkeypatch.setattr(layers, name, wrapped)
    return calls


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_family_matches_reference(monkeypatch, case, backend):
    _, arch, n_layers, prompt_len = next(c for c in CASES if c[0] == case)
    np_params, prompts, ex, fwd, toks, ref_logits = _reference(case)
    _, cfg = _cfgs(arch, n_layers)
    params = steps.params_from_numpy(np_params, cfg, "cpu")
    inputs = {k: torch.from_numpy(v) for k, v in ex.items()}
    tokens = torch.from_numpy(prompts)
    k6 = _counting(monkeypatch, "flash_attention")
    scan = _counting(monkeypatch, "_flash_attention_scan")
    common.reset_launches()

    with torch.no_grad():
        _close(steps.forward_logits(params, {"tokens": tokens, **inputs}, cfg,
                                    backend=backend), fwd)
    extras = {}
    if "image_embeds" in inputs:
        extras["image_embeds"] = inputs["image_embeds"]
    if "frames" in inputs:
        with torch.no_grad():
            extras["enc_out"] = whisper.encode(params, inputs["frames"], cfg,
                                               backend=backend)
    prefill, decode = steps.make_serve_steps(cfg, backend=backend)
    cache = steps.init_cache(cfg, BATCH, prompt_len + N_DECODE, "cpu")
    k6.clear(), scan.clear()
    logits, cache = prefill(params, tokens, cache, extras)
    _close(logits, ref_logits[0])

    # the long-sequence calls of one prefill: one per application of
    # zamba2's shared block; one per VLM layer and one per cross layer;
    # one per MoE layer
    long = prompt_len >= layers.LONG_SEQ
    per_prefill = {"hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1),
                   "vlm": cfg.n_layers + cfg.n_layers // max(
                       cfg.cross_attn_every, 1),
                   "moe": cfg.n_layers}.get(cfg.family, 0)
    expected = per_prefill if long else 0
    assert len(k6) == (expected if backend == "hopper" else 0)
    assert len(scan) == (expected if backend == "torch" else 0)
    if long and cfg.family == "vlm":      # the cross layers are not causal
        calls = k6 if backend == "hopper" else scan
        assert calls.count(False) == cfg.n_layers // cfg.cross_attn_every
    for i, tok in enumerate(toks):
        logits, cache = decode(params, torch.from_numpy(tok), cache,
                               prompt_len + i, extras)
        _close(logits, ref_logits[i + 1])
    assert len(k6) + len(scan) == expected
    logits, cache = prefill(params, tokens, cache, extras)
    _close(logits, ref_logits[-1])
    assert common.LAUNCHES == dict.fromkeys(common.KERNELS, 0)  # CPU: plain


def test_init_params_have_the_reference_trees_and_dtypes():
    """The port's random trees have the reference's structure and shapes
    for every new family; in bf16 the SSM's A_log, D and dt_bias leaves,
    the SSM state and the MoE router stay float32, as the reference's."""
    for arch, n_layers in (("mamba2-130m", None), ("zamba2-7b", 5),
                           ("whisper-base", None),
                           ("llama-3.2-vision-11b", None),
                           ("llama4-scout-17b-16e", None),
                           ("llama4-maverick-400b-a17b", None)):
        r_cfg, cfg = _cfgs(arch, n_layers)
        ref = jax.eval_shape(lambda k: r_steps.init_params(k, r_cfg),
                             jax.random.PRNGKey(0))
        params = steps.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
        assert layers._tree_map(lambda t: tuple(t.shape), params) == shapes
        bf16 = dataclasses.replace(cfg, dtype="bfloat16")
        r_bf16 = dataclasses.replace(r_cfg, dtype="bfloat16")
        ref16 = jax.eval_shape(lambda k: r_steps.init_params(k, r_bf16),
                               jax.random.PRNGKey(0))
        want = jax.tree.map(lambda a: str(a.dtype), ref16)
        got = steps.init_params(bf16, torch.Generator().manual_seed(0),
                                "cpu")
        assert layers._tree_map(lambda t: str(t.dtype).replace(
            "torch.", ""), got) == want
        carried = steps.params_from_numpy(
            jax.tree.map(lambda a: np.zeros(a.shape, np.float32), ref16),
            bf16, "cpu")
        assert layers._tree_map(lambda t: str(t.dtype).replace(
            "torch.", ""), carried) == want
        r_cache = jax.eval_shape(lambda: r_steps.init_cache(r_bf16, 2, 8))
        cache = steps.init_cache(bf16, 2, 8, "cpu")
        assert layers._tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            cache) == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                                   r_cache)


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b",
                                  "llama4-scout-17b-16e"])
def test_serve_draws_in_the_reference_order(arch, capsys):
    """``serve`` with the reference's own seeded parameters gives the
    reference ``serve``'s greedy tokens: the stub frontend's inputs, then
    the prompts, from one generator."""
    cfg = r_get_config(arch).reduced()
    ref_tokens = r_serve.serve(arch, reduced=True, batch=2, prompt_len=8,
                               gen=4, seed=0)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             r_steps.init_params(jax.random.PRNGKey(0), cfg))
    params = steps.params_from_numpy(np_params, get_config(arch).reduced(),
                                     "cpu")
    out = serve_mod.serve(arch, reduced=True, batch=2, prompt_len=8, gen=4,
                          seed=0, device="cpu", params=params)
    np.testing.assert_array_equal(out.tokens, ref_tokens)
    assert (out.encode_ms is not None) == (cfg.family == "audio")
    assert "prefill 8 toks x2" in capsys.readouterr().out


@pytest.mark.parametrize("n_layers", [None, 5])
def test_drift_tool_prefills_as_the_serve_step(n_layers):
    """``launch.drift.prefill_by_group`` (the group-by-group trace of a
    zamba2 prefill) gives the serve step's prefill logits."""
    from repro_torch.launch import drift
    _, cfg = _cfgs("zamba2-7b", n_layers)
    params = steps.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24), dtype=np.int32))
    states, logits = drift.prefill_by_group(params, cfg, tokens, "hopper")
    prefill, _ = steps.make_serve_steps(cfg, backend="hopper")
    ref, _ = prefill(params, tokens, steps.init_cache(cfg, 2, 24, "cpu"))
    assert len(states) == cfg.n_layers // cfg.shared_attn_every
    assert torch.equal(logits, ref)
