"""The decode step the card captures (``train.steps.DecodeStep``), on the
CPU.

The reference jits its decode step with the position traced; the port's
step object runs its eager function ``fn`` with the position as a 0-d
integer tensor, which on the card it captures as one CUDA graph a request
(the capture itself: ``tests/test_torch_gpu.py``). Here, at reduced
configs in fp32: each family's (dense, MoE, VLM, SSM, hybrid, audio, and
the dense model split along ``model``) greedy decode steps with a tensor
position equal, bit for bit, the same steps with a host int; the dense
decode through the step object holds to the reference's
``jax.jit(decode)`` with ``jnp.int32(pos)`` within ``rtol=atol=1e-4``;
each family's ``fn`` traces end to end under ``FakeTensorMode`` with a
fake position, where any host read of a device value raises; positions
past the cache or whisper's position table raise ``ValueError`` before
any work; a tensor ``cache_pos`` on the long-sequence branch raises
``TypeError``; the route is decided from the mesh; a graph whose tensors
died is dropped before any lookup.
"""
import gc
import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import (  # noqa: E402
    DataDependentOutputException,
    FakeTensorMode,
)

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.train import steps as r_steps  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import layers, transformer, whisper  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import steps  # noqa: E402

FAMILIES = {"dense": "minitron-8b", "moe": "llama4-scout-17b-16e",
            "vlm": "llama-3.2-vision-11b", "ssm": "mamba2-130m",
            "hybrid": "zamba2-7b", "audio": "whisper-base"}
BATCH, PROMPT, N_DECODE = 2, 8, 3


def _extras(cfg, params, rng):
    """A VLM's image embeddings or whisper's encoded frames, from ``rng``."""
    if cfg.family == "vlm":
        return {"image_embeds": torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))}
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            return {"enc_out": whisper.encode(params, frames, cfg)}
    return {}


def _model(family: str, mesh=None):
    """A reduced model of ``family`` (a VLM's cross-attention gates open),
    placed over ``mesh`` when given; its extras and prompts from seed 0,
    and the rules to build its caches under."""
    cfg = get_config(FAMILIES[family]).reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if family == "vlm":
        for slot in params["layers"]:
            if "xattn_gate" in slot:
                slot["xattn_gate"].fill_(0.5)
    rng = np.random.default_rng(0)
    extras = _extras(cfg, params, rng)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (BATCH, PROMPT), dtype=np.int32))
    rules = None
    if mesh is not None:
        rules = sharding.make_rules(make_mesh(
            mesh, ("data", "model"), devices=["cpu"] * (mesh[0] * mesh[1])))
        params = steps.place(cfg, params, rules)
    return cfg, params, extras, prompts, rules


def _cache(cfg, rules):
    with sharding.use_rules(rules):
        return steps.init_cache(cfg, BATCH, PROMPT + N_DECODE, "cpu")


def _leaves(cache):
    rows = cache.rows if isinstance(cache, layers.SplitCache) else cache
    return torch.utils._pytree.tree_leaves(rows)


@pytest.mark.parametrize("family,mesh", [
    *((f, None) for f in FAMILIES), ("dense", (1, 2)), ("dense", (2, 2))])
def test_tensor_position_decodes_as_the_int_position(family, mesh):
    """Greedy decode steps through ``fn`` with a 0-d tensor position,
    through ``fn`` with a host int, and through the step object (which on
    the CPU runs ``fn`` with the tensor): the logits at every step and the
    caches after them equal bit for bit."""
    cfg, params, extras, prompts, rules = _model(family, mesh)
    prefill, decode = steps.make_serve_steps(cfg)
    assert isinstance(decode, steps.DecodeStep)
    runs = {}
    for how in ("int", "tensor", "step"):
        cache = _cache(cfg, rules)
        logits, cache = prefill(params, prompts, cache, extras)
        got = [logits]
        for i in range(N_DECODE):
            tok = logits.argmax(-1)[:, None]
            pos = PROMPT + i
            if how == "step":
                logits, cache = decode(params, tok, cache, pos, extras)
            else:
                logits, cache = decode.fn(
                    params, tok, cache,
                    torch.tensor(pos) if how == "tensor" else pos, extras)
            got.append(logits)
        runs[how] = (got, _leaves(cache))
    assert decode.trace_count == 0          # nothing is captured on the CPU
    want, want_cache = runs["int"]
    for how in ("tensor", "step"):
        got, got_cache = runs[how]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), how
        assert all(torch.equal(a, b) for a, b in zip(got_cache, want_cache))


def test_step_object_matches_the_reference_jitted_decode():
    """Reduced minitron-8b, the reference's parameters carried across by
    ``transformer.params_from_numpy``: the prefill and three decode steps
    through the step object (teacher-forced with the reference's greedy
    tokens) against the reference's ``jax.jit`` prefill and decode with
    the position ``jnp.int32(pos)``, within ``rtol=atol=1e-4``."""
    r_cfg, cfg = r_get_config("minitron-8b").reduced(), \
        get_config("minitron-8b").reduced()
    r_params = r_steps.init_params(jax.random.PRNGKey(3), r_cfg)
    r_prefill, r_decode = map(jax.jit, r_steps.make_serve_steps(r_cfg))
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (BATCH, 16), dtype=np.int32)
    r_cache = r_steps.init_cache(r_cfg, BATCH, 16 + N_DECODE)
    r_logits, r_cache = r_prefill(r_params, jnp.asarray(prompts), r_cache)
    params = transformer.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), r_params), cfg,
        "cpu")
    prefill, decode = steps.make_serve_steps(cfg)
    cache = steps.init_cache(cfg, BATCH, 16 + N_DECODE, "cpu")
    logits, cache = prefill(params, torch.from_numpy(prompts), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=1e-4, atol=1e-4)
    for i in range(N_DECODE):
        tok = np.asarray(jnp.argmax(r_logits, -1))[:, None].astype(np.int32)
        r_logits, r_cache = r_decode(r_params, jnp.asarray(tok), r_cache,
                                     jnp.int32(16 + i))
        logits, cache = decode(params, torch.from_numpy(tok), cache, 16 + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fn_traces_under_fake_tensors_without_a_host_read(family):
    """Each family's ``fn`` on fake parameters, cache, token and a fake 0-d
    position (``launch.specs``' fake tensors): any ``int(...)`` or
    ``.item()`` of a device value raises under the fake mode, so a host
    read that would break the capture fails here. The step writes the
    cache in place and returns (B, V) logits."""
    cfg = get_config(FAMILIES[family]).reduced()
    mode = FakeTensorMode()
    params = specs.abstract_params(cfg, mode)
    cache = specs.abstract_cache(cfg, BATCH, 16, mode)
    _, decode = steps.make_serve_steps(cfg)
    with mode:
        token = torch.empty((BATCH, 1), dtype=torch.int32)
        pos = torch.empty((), dtype=torch.int64)
        extras = {}
        if family == "vlm":
            extras["image_embeds"] = torch.empty(
                (BATCH, cfg.n_image_tokens, cfg.d_model))
        if family == "audio":
            extras["enc_out"] = torch.empty(
                (BATCH, cfg.n_audio_frames, cfg.d_model))
        with pytest.raises(DataDependentOutputException):
            int(pos)                       # the probe this test relies on
        logits, out = decode.fn(params, token, cache, pos, extras)
    assert tuple(logits.shape) == (BATCH, cfg.vocab_size)
    assert out is cache


@pytest.mark.parametrize("family", ["dense", "hybrid", "audio"])
def test_positions_past_the_cache_raise_before_any_work(family):
    """``pos + s`` past the cache's positions (and, for whisper, past its
    4096-row position table) raises ``ValueError`` on the host, before
    the step runs; so does a prompt longer than the cache, and a negative
    position."""
    cfg, params, extras, prompts, _ = _model(family)
    prefill, decode = steps.make_serve_steps(cfg)
    cache = _cache(cfg, None)
    logits, cache = prefill(params, prompts, cache, extras)
    before = [t.clone() for t in _leaves(cache)]

    def boom(*args, **kwargs):
        raise AssertionError("the step ran")
    decode.fn = boom
    tok = logits.argmax(-1)[:, None]
    for pos in (PROMPT + N_DECODE, PROMPT + N_DECODE + 5, -1):
        with pytest.raises(ValueError, match="exceed the cache|negative"):
            decode(params, tok, cache, pos, extras)
    with pytest.raises(ValueError, match="exceed the cache"):
        decode(params, prompts, cache, PROMPT - 4, extras)
    with pytest.raises(ValueError, match="exceed the cache"):
        prefill(params, torch.cat([prompts] * 2, 1), cache, extras)
    if family == "audio":
        with pytest.raises(ValueError, match="4096-row position table"):
            decode(params, tok, cache, whisper.POS_ROWS, extras)
        with pytest.raises(ValueError, match="4096-row position table"):
            whisper.decode_step(params, tok, cache, whisper.POS_ROWS,
                                extras["enc_out"], cfg)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cache), before))


def test_tensor_cache_pos_on_the_long_sequence_branch_raises():
    """A tensor ``cache_pos`` with 2048 queries or more (K6's or the scan's
    branch, which need the row offset on the host) raises ``TypeError``
    before any work; the prefill's host int takes that branch."""
    cfg = get_config("minitron-8b").reduced()
    p = layers.init_attention(torch.Generator().manual_seed(0), cfg,
                              torch.float32, "cpu")
    x = torch.zeros((1, layers.LONG_SEQ, cfg.d_model))
    shape = (1, layers.LONG_SEQ + 4, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for backend in ("torch", "hopper"):
        with pytest.raises(TypeError, match="host int"):
            layers.attention(p, x, cfg, kv_cache=cache,
                             cache_pos=torch.tensor(0), backend=backend)
    assert not cache["k"].any()
    with pytest.raises(ValueError, match="exceed the cache"):
        layers.attention(p, x, cfg, kv_cache=cache, cache_pos=5)


def test_the_route_is_decided_from_the_mesh():
    """One device (no mesh, the unsplit mesh, a repeated card) is
    captured; distinct cards decode eagerly; a CPU mesh runs ``fn``.
    ``serve`` on the CPU reports its route and no capture."""
    cuda = [torch.device("cuda", i) for i in range(2)]
    mesh = lambda shape, devs: make_mesh(shape, ("data", "model"),  # noqa
                                         devices=devs)
    assert steps.decode_route() == "captured"
    assert steps.decode_route(mesh((1, 1), cuda[:1])) == "captured"
    assert steps.decode_route(mesh((2, 2), cuda[:1] * 4)) == "captured"
    assert steps.decode_route(mesh((1, 2), cuda)) == "eager: 2 cards"
    assert steps.decode_route(mesh((2, 2), cuda * 2)) == "eager: 2 cards"
    assert steps.decode_route(mesh((1, 2), ["cpu"] * 2)) == "eager: cpu"
    cfg = get_config("minitron-8b").reduced()
    rules = sharding.make_rules(mesh((1, 2), cuda))
    with sharding.use_rules(rules):
        _, decode = steps.make_serve_steps(cfg)
    assert decode.route == "eager: 2 cards"
    assert steps.make_serve_steps(cfg, mesh=mesh((1, 2), cuda[:1] * 2))[
        1].route == "captured"
    out = serve_mod.serve("minitron-8b", batch=2, prompt_len=8, gen=3,
                          device="cpu")
    assert (out.decode_route, out.decode_captures, out.capture_ms) == (
        "eager: cpu", 0, None)
    assert out.replay_ms_per_token > 0 and out.decode_ms_per_token > 0


def test_a_graph_whose_tensors_died_is_dropped_before_any_lookup():
    """The step's table of graphs (``core.executor._GraphTable``, as the
    CNN executor's): a graph holds what it reads by weak reference; once
    one of them dies the graph goes at the next lookup of any key, so a
    new cache at the freed one's address finds no graph to replay."""
    cfg = get_config("minitron-8b").reduced()
    _, decode = steps.make_serve_steps(cfg)
    params = torch.zeros(4)
    caches = [torch.zeros(3), torch.zeros(3)]

    def graph(*held):
        return steps._DecodeGraph(
            None, torch.zeros(1), torch.zeros(()), torch.zeros(1),
            tuple(weakref.ref(t) for t in held), [], {}, threading.Lock())
    for i, c in enumerate(caches):
        decode._graphs.put(("s", i), graph(params, c))
    assert len(decode._graphs) == 2 and decode._graphs.get(("s", 0))
    del c
    caches.pop(0)
    gc.collect()
    decode._graphs.drop_dead()
    assert len(decode._graphs) == 1
    assert decode._graphs.get(("s", 0)) is None
    assert decode._graphs.get(("s", 1)) is not None
