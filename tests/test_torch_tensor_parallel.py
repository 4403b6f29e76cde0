"""Tensor parallelism along the mesh's ``model`` axis for every LM family
(``parallel.sharding.place`` and the split paths of ``models/``), on
meshes of the repeated CPU device; the checks particular to the SSM block
(its ``in_proj`` columns, uneven SSM heads, its collectives) are in
``tests/test_torch_tensor_parallel_ssm.py``.

* Placement: each leaf of every dense arch's reduced tree, and of
  llama4-scout's, llama4-maverick's, llama-3.2-vision's, mamba2-130m's,
  zamba2-7b's and whisper-base's, placed by
  ``param_shardings`` on (1, 2), (1, 4) and (2, 4), holds one shard per
  ``model`` position with the shape of the reference's ``param_specs``
  (over a stand-in mesh of that shape), and gathers back bit for bit.
* Serving: prefill of a 32-token prompt and 4 decode steps teacher-forced
  with the reference's greedy tokens, on reduced minitron-8b (2 KV heads
  of 16 over 4 positions: the uneven-heads case), qwen3-32b
  (``qk_norm``), and scout, maverick, the VLM (with image embeddings),
  mamba2-130m, zamba2-7b (5 layers: two groups and a tail of one mamba
  layer without the shared block) and whisper-base (with frames, encoded
  over each tree); those last six with every leaf drawn anew from numpy,
  so no gate, bias or norm is at its init; on (1, 2), (1, 4) and (2, 4),
  each position's cache holding its KV heads, SSM heads and conv
  channels, against the unsplit port within ``1e-5 * max(1, max|ref|)``
  and the reference's single-device run within ``1e-4 * max(1,
  max|ref|)``; a 2048-token ``hopper`` prefill of minitron and of zamba2
  (K6's plain version, once per attention layer and position);
  ``launch.serve.serve`` over a (1, 2) mesh, each family (the SSM,
  hybrid and audio families too).
* Expert parallelism: each position runs its whole experts, routed from
  the whole router: every token takes the same expert, is kept or dropped
  as in the unsplit run; experts that do not divide the positions (6 on
  4; 4 on 8, where half the positions hold none) serve as unsplit. The
  VLM over (2, 2) hands each data row its own rows of the image
  embeddings.
* Training: ``loss_and_grads`` of a placed tree against the unsplit one
  (whisper's ``b_out``, added once after the all-reduce, has the unsplit
  gradient); the mesh step over (2, 2) against the one-position step by
  ``adamw.step_gaps``: each gradient leaf within 1e-5 of its own max|g|,
  the parameters within 1e-4 wherever the gradient is well above AdamW's
  eps, every element the one-position step moved moved;
  a replicated leaf's gradient is the sum of its uses on every position;
  ``global_norm`` of a placed tree equals the unsplit tree's; the
  collectives a split step declares to the roofline, forward and
  backward, equal their sum from the shapes (the loss over the
  positions' vocabulary shares: three all-reduces of (N,) rows, no
  gather of the logits).
* Checkpoints: a placed tree (minitron, scout, mamba2) saves the bytes of
  an unsplit save and reads back bit for bit unsplit, or split onto
  ``param_shardings``;
  ``run_with_recovery`` and ``elastic_restore`` keep or make the split.
* Query heads that straddle KV groups (48 over 8 on 6 positions, 40
  over 8 on 3) index their K and V to one KV head per query head and
  serve and train as unsplit, K6 at the position's heads; ranges inside
  a group or on group boundaries keep their equal blocks.
  Shares may be uneven or empty: the production mesh's 16 positions give
  scout and maverick 2 or 3 of their 40 heads, whisper-base one head or
  none; reduced scout with 10 heads over 4 positions, whisper over 8 and
  mamba2 over 16 (half the positions without an attention or SSM head,
  running none) serve and take a mesh step as unsplit.
* The SSM and hybrid families through the placement entry points:
  ``steps.place`` gives them ``Placed`` leaves and a
  ``layers.SplitCache``, and ``launch.train.build`` trains them over a
  (2, 2) mesh as the one position does.
"""
import dataclasses
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.models import whisper as r_whisper  # noqa: E402
from repro.parallel import sharding as r_sharding  # noqa: E402
from repro.train import steps as r_steps  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import elastic_restore  # noqa: E402
from repro_torch.checkpoint import run_with_recovery  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import layers, mamba2, transformer  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import Placed  # noqa: E402
from repro_torch.train import steps  # noqa: E402

DENSE = ["minitron-8b", "internlm2-20b", "qwen3-32b", "command-r-35b"]
SCOUT, MAVERICK = "llama4-scout-17b-16e", "llama4-maverick-400b-a17b"
# reduced scout with 10 query heads over 2 KV heads: on 4 positions the
# shares are 2, 3, 2 and 3 heads, each inside one KV group (5 a group)
SCOUT_10 = "llama4-scout-10-heads"
VARIANTS = {SCOUT_10: (SCOUT, dict(n_heads=10, n_kv_heads=2))}
VISION = "llama-3.2-vision-11b"
MOE_VLM = [SCOUT, MAVERICK, VISION]
SSM_AUDIO = ["mamba2-130m", "zamba2-7b", "whisper-base"]
# the layers kept where the reduced config's are not: zamba2 at 5 has a
# tail of one mamba layer without the shared block
LAYERS = {"zamba2-7b": 5}
MESHES = [(1, 2), (1, 4), (2, 4)]
BATCH, PROMPT, N_DECODE = 4, 32, 4
SPLIT_TOL, REF_TOL = 1e-5, 1e-4
# gradients of a placed tree against the unsplit ones, relative to
# max(1, max|g|): the SSM block's split sums in another order what the
# unsplit block sums in one product (the gated norm's variance,
# ``out_proj``'s rows, B and C's gradient over every position's heads),
# and drawn leaves carry those differences through every layer's
# backward (2.5e-6 the largest seen)
GRAD_TOL = {"ssm": 1e-5, "hybrid": 1e-5, "audio": 1e-5}
# a split step against the one-position step (``adamw.step_gaps``, the
# rule ``chip_smoke.py`` holds on the card): each gradient leaf relative
# to its own max|g| (a leaf that sums many terms that cancel, mamba2's
# ``conv_b``, reads 4.5e-5 on an H100, 4.8e-6 here), the parameters
# wherever the gradient is well above AdamW's eps
STEP_GRAD_TOL, STEP_PARAM_TOL = 1e-4, 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _cfg(arch, r=False):
    """The reduced config (the reference's with ``r``), LAYERS and
    VARIANTS applied."""
    base, changes = VARIANTS.get(arch, (arch, {}))
    cfg = (r_get_config if r else get_config)(base).reduced()
    if arch in LAYERS:
        changes = dict(changes, n_layers=LAYERS[arch])
    return dataclasses.replace(cfg, **changes)


class _StandIn:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


def _rules(shape):
    return sharding.make_rules(_mesh(shape))


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _placed(params, shape):
    rules = _rules(shape)
    return sharding.place(params, sharding.param_shardings(params, rules)), \
        rules


def _close(out, ref, rel):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)
    ref = ref.detach().float().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref, np.float32)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert out.shape == ref.shape and err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", DENSE + MOE_VLM + SSM_AUDIO)
def test_placed_shards_have_the_reference_shard_shapes(arch, mesh_shape):
    cfg = get_config(arch).reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed, rules = _placed(params, mesh_shape)
    abstract = jax.eval_shape(lambda: r_steps.init_params(
        jax.random.PRNGKey(0), r_get_config(arch).reduced()))
    r_specs = r_sharding.param_specs(
        abstract, r_sharding.make_rules(_StandIn(mesh_shape,
                                                 ("data", "model"))))
    sizes = dict(zip(("data", "model"), mesh_shape))
    want = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(abstract)[0],
            jax.tree_util.tree_leaves(
                r_specs, is_leaf=lambda x: isinstance(x, r_sharding.P))):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                shape[d] //= sizes[entry]
        want[_key(path)] = tuple(shape)
    got = pytree.tree_flatten_with_path(
        placed, is_leaf=lambda x: isinstance(x, Placed))[0]
    whole = dict(pytree.tree_flatten_with_path(params)[0])
    assert {_key(p) for p, _ in got} == set(want)
    devices = rules.mesh.devices[0].tolist()
    for path, leaf in got:
        assert isinstance(leaf, Placed) and leaf.devices == devices
        assert tuple(leaf.shape) == whole[path].shape
        for i, t in enumerate(leaf.shards):
            assert tuple(t.shape) == want[_key(path)], _key(path)
            assert t.device == devices[i] and t.is_contiguous()
        assert len(leaf.parts) == (1 if leaf.dim is None else len(devices))
        assert torch.equal(leaf.gather(), whole[path])
    # the shards are fresh: the placed tree shares no storage with params
    held = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves(
        params)}
    assert not held & {t.untyped_storage().data_ptr()
                       for t in pytree.tree_leaves(placed)}


def test_uneven_heads_compute_whole_heads():
    """Reduced minitron on 4 positions: ``wk``/``wv`` hold half a KV head
    each (2 KV heads of 16 over 4 positions), as the reference splits the
    flat columns; position i computes query head i with the whole KV head
    i // 2, assembled from positions 2 (i // 2) and 2 (i // 2) + 1."""
    cfg = get_config("minitron-8b").reduced()
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (4, 2, 16)
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed, _ = _placed(params, (1, 4))
    wk = placed["layers"][0]["attn"]["wk"]
    assert [tuple(t.shape) for t in wk.shards] == [(4, 64, 8)] * 4
    for i in range(4):
        tree = transformer._position_tree(placed, cfg, i)
        k = i // 2
        assert torch.equal(tree["layers"][0]["attn"]["wk"],
                           params["layers"][0]["attn"]["wk"][
                               ..., k * 16:(k + 1) * 16])
        assert torch.equal(tree["layers"][0]["attn"]["wq"],
                           wq_i := params["layers"][0]["attn"]["wq"][
                               ..., i * 16:(i + 1) * 16])
        assert tree["layers"][0]["attn"]["wq"] is \
            placed["layers"][0]["attn"]["wq"].parts[i]
        assert wq_i.shape == (4, 64, 16)
    # on 8 positions every other one holds no query head and no KV head,
    # and its attention tree is None (it runs no attention)
    shares = [transformer._tp_ranges(cfg, 8, i) for i in range(8)]
    assert [r["heads"] for r in shares] == [(i // 2, (i + 1) // 2)
                                            for i in range(8)]
    placed8, _ = _placed(params, (1, 8))
    for i, r in enumerate(shares):
        k0, k1 = r["kv_heads"]
        attn = transformer._position_tree(placed8, cfg, i)["layers"][0][
            "attn"]
        if i % 2 == 0:
            assert k0 == k1 and attn is None
        else:
            assert (k0, k1) == (i // 4, i // 4 + 1)
            assert attn["wq"].shape == (4, 64, 16)


def test_production_head_shares_over_sixteen_positions():
    """The production mesh's 16 ``model`` positions: llama4-scout's and
    llama4-maverick's 40 query heads over 8 KV heads give shares of 2 and
    3 heads, each inside one KV group of 5; whisper-base's 8 over 8 give
    every odd position one head and every even position none; 48 over 8
    on 6 positions give 8 heads a position, each share straddling two KV
    groups of 6 with its first head at place 0, 2 or 4 of its first group
    (``q_offset``; ``test_query_heads_keep_whole_kv_groups`` serves
    them)."""
    for arch in (SCOUT, MAVERICK):
        cfg = get_config(arch)
        assert (cfg.n_heads, cfg.n_kv_heads) == (40, 8)
        shares = [layers._tp_ranges(cfg, 16, i) for i in range(16)]
        heads = [r["heads"] for r in shares]
        assert [h1 - h0 for h0, h1 in heads] == [2, 3] * 8
        assert heads[3] == (7, 10) and shares[3]["kv_heads"] == (1, 2)
        for r in shares:
            (h0, h1), (k0, k1) = r["heads"], r["kv_heads"]
            assert k1 - k0 == 1 and 5 * k0 <= h0 < h1 <= 5 * k1
    cfg = get_config("whisper-base")
    shares = [layers._tp_ranges(cfg, 16, i) for i in range(16)]
    assert [r["heads"] for r in shares] == [
        (i // 2, (i + 1) // 2) for i in range(16)]
    assert [r["kv_heads"] for r in shares] == [r["heads"] for r in shares]
    for arch in (SCOUT, MAVERICK, "whisper-base"):
        assert all(layers._tp_ranges(get_config(arch), 16, i)["q_offset"]
                   is None for i in range(16))
    wide = get_config("internlm2-20b")
    assert (wide.n_heads, wide.n_kv_heads) == (48, 8)
    shares = [layers._tp_ranges(wide, 6, i) for i in range(6)]
    assert [r["heads"] for r in shares] == [(8 * i, 8 * i + 8)
                                            for i in range(6)]
    assert [r["kv_heads"] for r in shares] == [(0, 2), (1, 3), (2, 4),
                                               (4, 6), (5, 7), (6, 8)]
    assert [r["q_offset"] for r in shares] == [0, 2, 4, 0, 2, 4]


@pytest.mark.parametrize("positions", [4, 6, 8, 16])
def test_query_heads_keep_whole_kv_groups(positions):
    """48 query heads over 8 KV heads (internlm2-20b's ratio: groups of
    6). On 4 or 8 positions each position's heads start and end on group
    boundaries, on 16 its 3 heads lie inside one group: their KV heads
    pair in equal blocks (no ``q_offset``). On 6, position 0's heads
    [0, 8) read KV heads 0 and 1 six and two times: each position's K and
    V are indexed to one KV head per query head (after its cache, which
    holds its KV heads). All four split and serve as the unsplit model
    does."""
    cfg = dataclasses.replace(get_config("internlm2-20b").reduced(),
                              n_heads=48, n_kv_heads=8, head_dim=4)
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 8), dtype=np.int32)
    toks = [prompts[:, :1]]
    whole = _serve_run(params, cfg, prompts, toks, steps.init_cache(
        cfg, 2, 9, "cpu"))
    placed, rules = _placed(params, (1, positions))
    batch = {"tokens": torch.from_numpy(prompts)}
    offsets = [layers._tp_ranges(cfg, positions, i)["q_offset"]
               for i in range(positions)]
    assert offsets == ([0, 2, 4, 0, 2, 4] if positions == 6
                       else [None] * positions)
    _close(steps.forward_logits(placed, batch, cfg),
           steps.forward_logits(params, batch, cfg), SPLIT_TOL)
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, 2, 9, "cpu")
    assert [c[0]["k"].shape[-2] for c in cache.rows[0]] == [
        k1 - k0 for k0, k1 in (layers._tp_ranges(cfg, positions, i)[
            "kv_heads"] for i in range(positions))]
    for got, want in zip(_serve_run(placed, cfg, prompts, toks, cache),
                         whole):
        _close(got, want, SPLIT_TOL)


STRADDLE = [("internlm2-20b", 48, 8, 6), (SCOUT, 40, 8, 3)]


@pytest.mark.parametrize("arch,heads,kv_heads,positions", STRADDLE,
                         ids=[f"{h}_over_{k}_on_{n}"
                              for _, h, k, n in STRADDLE])
def test_heads_that_straddle_kv_groups_serve_and_train_as_unsplit(
        arch, heads, kv_heads, positions):
    """48 query heads over 8 KV heads on 6 positions (internlm2-20b's
    ratio), and 40 over 8 on 3 (scout's, shares of 13, 13 and 14 heads):
    every position's share straddles KV groups. A prefill and 4 decode
    steps serve as unsplit (``SPLIT_TOL``); ``loss_and_grads`` gives the
    unsplit loss within 1e-6 and each gradient within 1e-6 of max(1,
    max|g|), as ``test_split_loss_and_grads_match_unsplit``'s dense and
    MoE cases; a 2048-token ``hopper`` prefill runs K6's plain version
    once per layer and position at the position's heads, each over as
    many KV heads."""
    cfg = dataclasses.replace(_cfg(arch), n_heads=heads,
                              n_kv_heads=kv_heads, head_dim=4)
    shares = [layers._tp_ranges(cfg, positions, i) for i in range(positions)]
    assert all(r["q_offset"] is not None for r in shares)
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed, rules = _placed(params, (1, positions))
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8), dtype=np.int32)
    toks = [prompts[:, i:i + 1] for i in range(N_DECODE)]
    whole = _serve_run(params, cfg, prompts, toks, steps.init_cache(
        cfg, 2, 8 + N_DECODE, "cpu"))
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, 2, 8 + N_DECODE, "cpu")
    for got, want in zip(_serve_run(placed, cfg, prompts, toks, cache),
                         whole):
        _close(got, want, SPLIT_TOL)
    b = _batch(cfg)
    loss, grads = steps.loss_and_grads(params, b, cfg)
    s_loss, s_grads = steps.loss_and_grads(placed, b, cfg)
    assert abs(float(s_loss) - float(loss)) <= 1e-6 * float(loss)
    for g, want in zip(pytree.tree_leaves(sharding.gather(s_grads)),
                       pytree.tree_leaves(grads)):
        _close(g, want, 1e-6)
    calls = []
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)
    long = {"tokens": torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 2048), dtype=np.int32))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "flash_attention", spy)
        got = steps.forward_logits(placed, long, cfg, backend="hopper")
    want = steps.forward_logits(params, long, cfg, backend="hopper")
    _close(got, want, SPLIT_TOL)
    assert calls == [((1, h1 - h0, 2048, 4), (1, h1 - h0, 2048, 4))
                     for _ in range(cfg.n_layers)
                     for h0, h1 in (r["heads"] for r in shares)]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _drawn(params, rng):
    """A reference tree with every leaf drawn anew from numpy (float32): a
    constant leaf (zeros, ones: norms, the cross-attention gate) becomes
    that constant plus 0.3 N(0, 1), any other keeps its init's spread."""
    def draw(a):
        a = np.asarray(a, np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return a.flat[0] + 0.3 * noise if np.all(a == a.flat[0]) \
            else noise * a.std()
    return jax.tree.map(draw, params)


def _image_embeds(cfg, rows, seed=6):
    """A VLM's stub image embeddings (float32 numpy), else None."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (rows, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


def _frames(cfg, rows, seed=7):
    """whisper's stub frame embeddings (float32 numpy), else None."""
    if cfg.family != "audio":
        return None
    return np.random.default_rng(seed).standard_normal(
        (rows, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def served_ref():
    """The reference's reduced minitron-8b, qwen3-32b, scout, maverick,
    VLM, mamba2, zamba2 and whisper served once on one device: prompts,
    its greedy tokens, its logits at prefill and each decode step, its
    parameters as float32 numpy (all but minitron's and qwen3's drawn
    anew, :func:`_drawn`), the VLM's image embeddings and whisper's
    frames."""
    out = {}
    for arch in ("minitron-8b", "qwen3-32b", *MOE_VLM, *SSM_AUDIO, SCOUT_10):
        cfg = _cfg(arch, r=True)
        params = r_steps.init_params(jax.random.PRNGKey(0), cfg)
        if arch in MOE_VLM + SSM_AUDIO + [SCOUT_10]:
            params = jax.tree.map(jnp.asarray, _drawn(
                params, np.random.default_rng(len(arch))))
        images, frames = _image_embeds(cfg, BATCH), _frames(cfg, BATCH)
        extras = {} if images is None else {
            "image_embeds": jnp.asarray(images)}
        if frames is not None:
            extras["enc_out"] = r_whisper.encode(params, jnp.asarray(frames),
                                                 cfg)
        prefill, decode = r_steps.make_serve_steps(cfg)
        prefill, decode = jax.jit(prefill), jax.jit(decode)
        prompts = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
        cache = r_steps.init_cache(cfg, BATCH, PROMPT + N_DECODE)
        logits, cache = prefill(params, jnp.asarray(prompts), cache, extras)
        all_logits, toks = [np.asarray(logits)], []
        for i in range(N_DECODE):
            tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(
                np.int32)
            toks.append(tok)
            logits, cache = decode(params, jnp.asarray(tok), cache,
                                   jnp.int32(PROMPT + i), extras)
            all_logits.append(np.asarray(logits))
        out[arch] = (jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  params), prompts, toks, all_logits, images,
                     frames)
    return out


def _serve_run(params, cfg, prompts, toks, cache, backend="torch",
               images=None, frames=None):
    prefill, decode = steps.make_serve_steps(cfg, backend=backend)
    extras = None if images is None else {
        "image_embeds": torch.from_numpy(images)}
    if frames is not None:
        with torch.no_grad():
            extras = {"enc_out": whisper.encode(
                params, torch.from_numpy(frames), cfg, backend=backend)}
    logits, cache = prefill(params, torch.from_numpy(prompts), cache, extras)
    out = [logits]
    for i, tok in enumerate(toks):
        logits, cache = decode(params, torch.from_numpy(tok), cache,
                               prompts.shape[1] + i, extras)
        out.append(logits)
    return out


def _assert_cache_shares(cache, cfg, mesh_shape):
    """Each position of the last data row holds its KV heads, SSM heads
    and conv channels of that row's sequences."""
    rows, n = mesh_shape
    assert isinstance(cache, layers.SplitCache)
    assert [len(r) for r in cache.rows] == [n] * rows
    for i, c in enumerate(cache.rows[-1]):
        share = layers._tp_ranges(cfg, n, i)
        if cfg.family in ("ssm", "hybrid"):
            heads, conv = mamba2.conv_channels(cfg, share)
            pre = "" if cfg.family == "ssm" else "groups_"
            ssm, conv_c = c[pre + "ssm"], c[pre + "conv"]
            assert ssm.shape[-3] == heads and conv_c.shape[-1] == conv
            assert ssm.shape[-4] == BATCH // rows
        if cfg.family != "ssm":
            k0, k1 = share["kv_heads"]
            k = {"audio": "k", "hybrid": "attn_k"}.get(cfg.family)
            k = c[k] if k else c[0]["k"]
            assert k.shape[-2] == k1 - k0 and k.shape[-4] == BATCH // rows
            assert k.shape[-3] == PROMPT + N_DECODE


# shares that are uneven or empty: scout's 10 heads over 4 positions (2,
# 3, 2, 3), whisper's 4 over 8 and mamba2's 8 SSM heads over 16 (every
# other position holds none)
NEW_SHARES = [(SCOUT_10, (1, 4)), ("whisper-base", (1, 8)),
              ("mamba2-130m", (1, 16))]


@pytest.mark.parametrize("arch,mesh_shape", [
    ("minitron-8b", (1, 2)), ("minitron-8b", (1, 4)), ("minitron-8b", (2, 4)),
    ("qwen3-32b", (1, 4)),
    *((arch, shape) for arch in MOE_VLM + SSM_AUDIO for shape in MESHES),
    *NEW_SHARES], ids=str)
def test_split_serving_matches_unsplit_and_reference(served_ref, arch,
                                                     mesh_shape):
    np_params, prompts, toks, ref_logits, images, frames = served_ref[arch]
    cfg = _cfg(arch)
    params = steps.params_from_numpy(np_params, cfg, "cpu")
    whole = _serve_run(params, cfg, prompts, toks, steps.init_cache(
        cfg, BATCH, PROMPT + N_DECODE, "cpu"), images=images, frames=frames)
    placed, rules = _placed(params, mesh_shape)
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, BATCH, PROMPT + N_DECODE, "cpu")
    _assert_cache_shares(cache, cfg, mesh_shape)
    split = _serve_run(placed, cfg, prompts, toks, cache, images=images,
                       frames=frames)
    for got, want, ref in zip(split, whole, ref_logits):
        _close(got, want, SPLIT_TOL)
        _close(got, ref, REF_TOL)


@pytest.mark.parametrize("arch", ["minitron-8b", "zamba2-7b"])
def test_split_hopper_prefill_calls_k6_per_position(monkeypatch, arch):
    """A 2048-token prompt on ``hopper`` over (1, 2): each position calls
    K6 (its plain version here) on its own heads (2 query heads over 1 KV
    head), once per attention layer (zamba2: once per group, its shared
    block), and the logits hold the unsplit ``hopper`` prefill's to
    1e-5."""
    cfg = _cfg(arch)
    params = steps.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, layers.LONG_SEQ), dtype=np.int32)
    whole = _serve_run(params, cfg, prompts, [], steps.init_cache(
        cfg, 1, layers.LONG_SEQ, "cpu"), backend="hopper")
    calls = []
    k6 = layers.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return k6(q, k, v, **kw)
    monkeypatch.setattr(layers, "flash_attention", counted)
    placed, rules = _placed(params, (1, 2))
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, 1, layers.LONG_SEQ, "cpu")
    split = _serve_run(placed, cfg, prompts, [], cache, backend="hopper")
    every = cfg.shared_attn_every
    n_attn = cfg.n_layers // every if every else cfg.n_layers
    assert calls == [((1, 2, layers.LONG_SEQ, 16),
                      (1, 1, layers.LONG_SEQ, 16))] * (2 * n_attn)
    _close(split[0], whole[0], SPLIT_TOL)


@pytest.mark.parametrize("arch", ["minitron-8b", *MOE_VLM, *SSM_AUDIO])
def test_serve_entry_point_over_a_split_mesh(capsys, monkeypatch, arch):
    """``launch.serve.serve`` over the host's mesh: (1, 1) on the CPU, and
    a host of two positions (the repeated CPU standing in) splits."""
    kw = dict(reduced=True, batch=2, prompt_len=16, gen=4, device="cpu")
    one = serve_mod.serve(arch, **kw)
    assert "split along model" not in capsys.readouterr().out
    monkeypatch.setattr(serve_mod, "make_host_mesh",
                        lambda device_type: _mesh((1, 2)))
    two = serve_mod.serve(arch, **kw)
    assert "split along model" in capsys.readouterr().out
    _close(two.prefill_logits, one.prefill_logits, SPLIT_TOL)
    np.testing.assert_array_equal(two.tokens, one.tokens)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

class _Routing:
    """Records, while entered, each ``transformer.moe`` call's routing per
    token: the expert (the first maximum of the float32 router logits),
    whether it was kept (its place in its expert's bucket below the
    capacity) and the expert range the call computed."""

    def __init__(self, monkeypatch):
        self.calls = []
        moe = layers.moe

        def recording(p, x, cfg, experts=None):
            idx = (x.float() @ p["router"]).argmax(-1)
            cap = max(1, int(cfg.capacity_factor * x.shape[1]
                             / cfg.n_experts) + 1)
            onehot = torch.nn.functional.one_hot(idx, cfg.n_experts)
            pos = (onehot.cumsum(1) - 1).gather(-1, idx[..., None])[..., 0]
            self.calls.append((idx, pos < cap, experts))
            return moe(p, x, cfg, experts=experts)
        monkeypatch.setattr(transformer, "moe", recording)


def _split_moe_cfg(**kw):
    return dataclasses.replace(get_config(SCOUT).reduced(), **kw)


@pytest.mark.parametrize("arch,mesh_shape", [(SCOUT, (1, 4)),
                                             (MAVERICK, (2, 2))], ids=str)
def test_split_routing_equals_unsplit(monkeypatch, arch, mesh_shape):
    """Every position routes from the whole router, so each token takes
    the expert it takes unsplit, and is kept or dropped as unsplit, at
    prefill (32 tokens a row over 4 experts of capacity 11: drops) and
    each decode step; each position computes its own range of experts."""
    cfg = get_config(arch).reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    toks = [np.full((BATCH, 1), t, np.int32) for t in (3, 5, 7, 11)]
    whole = _Routing(monkeypatch)
    _serve_run(params, cfg, prompts, toks, steps.init_cache(
        cfg, BATCH, PROMPT + N_DECODE, "cpu"))
    placed, rules = _placed(params, mesh_shape)
    split = _Routing(monkeypatch)
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, BATCH, PROMPT + N_DECODE, "cpu")
    _serve_run(placed, cfg, prompts, toks, cache)
    rows, n = mesh_shape
    ranges = [transformer._tp_ranges(cfg, n, i)["experts"]
              for i in range(n)]
    assert ranges == [(i * cfg.n_experts // n, (i + 1) * cfg.n_experts // n)
                      for i in range(n)]
    assert len(split.calls) == rows * n * len(whole.calls)
    assert any(not bool(kept.all()) for _, kept, _ in whole.calls)
    per, m = BATCH // rows, len(whole.calls) // (1 + N_DECODE)
    # the split run's calls: each step, each data row, each MoE layer,
    # each position
    for c, (idx, kept, experts) in enumerate(whole.calls):
        assert experts == (0, cfg.n_experts)
        step, layer = divmod(c, m)
        for r in range(rows):
            for i in range(n):
                s_idx, s_kept, s_experts = split.calls[
                    ((step * rows + r) * m + layer) * n + i]
                assert s_experts == ranges[i]
                assert torch.equal(s_idx, idx[r * per:(r + 1) * per])
                assert torch.equal(s_kept, kept[r * per:(r + 1) * per])


@pytest.mark.parametrize("experts,positions,heads", [(6, 4, 4), (4, 8, 8)])
def test_experts_that_do_not_divide_the_positions(experts, positions, heads):
    """Scout with 6 experts on 4 positions, and with 4 experts (and 8
    query heads over 2 KV heads) on 8: ``param_shardings`` leaves the
    expert leaves and the router whole, each position cuts its range of
    experts from the master copy (on 8 positions half of them hold none
    and give their shared-expert share only), and prefill and 4 decode
    steps hold the unsplit run to 1e-5."""
    cfg = _split_moe_cfg(n_experts=experts, n_heads=heads)
    params = steps.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    toks = [np.full((BATCH, 1), t, np.int32) for t in (2, 4, 6, 8)]
    whole = _serve_run(params, cfg, prompts, toks, steps.init_cache(
        cfg, BATCH, PROMPT + N_DECODE, "cpu"))
    placed, rules = _placed(params, (1, positions))
    m = placed["layers"][0]["moe"]
    assert m["we_gate"].dim is None and m["router"].dim is None
    assert m["shared"]["w_gate"].dim == 2
    ranges = [transformer._tp_ranges(cfg, positions, i)["experts"]
              for i in range(positions)]
    assert ranges[0][0] == 0 and ranges[-1][1] == experts
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert (sum(e1 == e0 for e0, e1 in ranges)
            == max(0, positions - experts))
    for i, (e0, e1) in enumerate(ranges):
        tree = transformer._position_tree(placed, cfg, i)["layers"][0]
        assert torch.equal(tree["moe"]["we_down"],
                           params["layers"][0]["moe"]["we_down"][:, e0:e1])
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, BATCH, PROMPT + N_DECODE, "cpu")
    for got, want in zip(_serve_run(placed, cfg, prompts, toks, cache),
                         whole):
        _close(got, want, SPLIT_TOL)


def test_moe_expert_ranges_sum_to_the_whole_call():
    """``layers.moe`` over disjoint expert ranges, each with its share of
    the shared expert's hidden units, sums to the whole call (the range
    ``(0, E)`` is the default call bit for bit); a range of no expert
    gives the shared share alone."""
    cfg = _split_moe_cfg(n_experts=6)
    p = steps.init_params(cfg, torch.Generator().manual_seed(4), "cpu")[
        "layers"][0]["moe"]
    p = layers.layer_at(p, 0)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32))
    want = layers.moe(p, x, cfg)
    assert torch.equal(layers.moe(p, x, cfg, experts=(0, 6)), want)
    cuts = [(0, 0), (0, 1), (1, 3), (3, 3), (3, 6)]
    f = cfg.d_ff
    total = 0
    for k, (e0, e1) in enumerate(cuts):
        f0, f1 = k * f // len(cuts), (k + 1) * f // len(cuts)
        part = {"router": p["router"],
                **{n: p[n][e0:e1] for n in ("we_gate", "we_up", "we_down")},
                "shared": {"w_gate": p["shared"]["w_gate"][:, f0:f1],
                           "w_up": p["shared"]["w_up"][:, f0:f1],
                           "w_down": p["shared"]["w_down"][f0:f1]}}
        out = layers.moe(part, x, cfg, experts=(e0, e1))
        if e0 == e1:
            assert torch.equal(out, layers.swiglu(part["shared"], x))
        total = total + out
    _close(total, want, SPLIT_TOL)


def test_vlm_over_two_data_rows_reads_each_rows_images(served_ref):
    """The VLM over (2, 2): each data row decodes its half of the batch
    against its half of the image embeddings, on its own devices; the
    logits hold the unsplit run's to 1e-5 and the reference's to 1e-4."""
    np_params, prompts, toks, ref_logits, images, _ = served_ref[VISION]
    cfg = get_config(VISION).reduced()
    params = transformer.params_from_numpy(np_params, cfg, "cpu")
    whole = _serve_run(params, cfg, prompts, toks, steps.init_cache(
        cfg, BATCH, PROMPT + N_DECODE, "cpu"), images=images)
    placed, rules = _placed(params, (2, 2))
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, BATCH, PROMPT + N_DECODE, "cpu")
    assert len(cache.rows) == 2
    seen = []
    attention = layers.attention

    def recording(p, x, cfg, **kw):
        if kw.get("xattn_kv") is not None:
            seen.append(kw["xattn_kv"])
        return attention(p, x, cfg, **kw)
    transformer.attention = recording
    try:
        split = _serve_run(placed, cfg, prompts, toks, cache, images=images)
    finally:
        transformer.attention = attention
    half = BATCH // 2
    n_cross = cfg.n_layers // cfg.cross_attn_every
    # per step: row 0's positions, then row 1's, at every cross layer
    assert len(seen) == (1 + N_DECODE) * 2 * n_cross * 2
    for k, kv in enumerate(seen):
        r = (k // (2 * n_cross)) % 2
        assert np.array_equal(kv.numpy(), images[r * half:(r + 1) * half])
    for got, want, ref in zip(split, whole, ref_logits):
        _close(got, want, SPLIT_TOL)
        _close(got, ref, REF_TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(cfg, rows=4, seq=16):
    """The data pipeline's batch of step 0; a VLM's with image
    embeddings, whisper's with frames."""
    b = batch_for_step(DataConfig(cfg.vocab_size, seq, rows), 0)
    images, frames = _image_embeds(cfg, rows), _frames(cfg, rows)
    if images is not None:
        b["image_embeds"] = images
    if frames is not None:
        b["frames"] = torch.from_numpy(frames)
    return b


def _redrawn(params, seed):
    """A port tree with every leaf drawn anew from numpy, as
    :func:`_drawn` draws the reference's (each leaf keeps its dtype)."""
    rng = np.random.default_rng(seed)

    def draw(t):
        a = t.float().numpy()
        noise = rng.standard_normal(a.shape).astype(np.float32)
        a = a.flat[0] + 0.3 * noise if np.all(a == a.flat[0]) \
            else noise * a.std()
        return torch.from_numpy(a).to(t.dtype)
    return pytree.tree_map(draw, params)


@pytest.mark.parametrize("arch,mesh_shape", [
    ("minitron-8b", (1, 4)), ("qwen3-32b", (1, 2)), (SCOUT, (1, 4)),
    (MAVERICK, (1, 2)), (VISION, (1, 4)), ("mamba2-130m", (1, 4)),
    ("zamba2-7b", (1, 2)), ("whisper-base", (1, 4))])
def test_split_loss_and_grads_match_unsplit(arch, mesh_shape):
    """Loss within 1e-6; each gradient and ``global_norm`` within 1e-6
    (the SSM, hybrid and audio families' leaves drawn anew: GRAD_TOL).
    whisper's ``b_out``: added once after the all-reduce, its gradient
    (every position's use summed on the master copy) is the unsplit one;
    added inside each position's partial it would count n times."""
    cfg = _cfg(arch)
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "vlm":
        for slot in params["layers"]:
            if "xattn_gate" in slot:
                slot["xattn_gate"].fill_(0.5)
    if arch in SSM_AUDIO:
        params = _redrawn(params, len(arch))
    tol = GRAD_TOL.get(cfg.family, 1e-6)
    placed, _ = _placed(params, mesh_shape)
    b = _batch(cfg)
    loss, grads = steps.loss_and_grads(params, b, cfg)
    s_loss, s_grads = steps.loss_and_grads(placed, b, cfg)
    assert abs(float(s_loss) - float(loss)) <= 1e-6 * float(loss)
    assert pytree.tree_structure(s_grads) == pytree.tree_structure(placed)
    for g, want in zip(pytree.tree_leaves(sharding.gather(s_grads)),
                       pytree.tree_leaves(grads)):
        _close(g, want, tol)
    if cfg.family == "audio":
        for part in ("enc_layers", "dec_layers"):
            want = grads[part]["ffn"]["b_out"]
            got = s_grads[part]["ffn"]["b_out"]
            assert len(got.parts) == 1 and float(want.abs().min()) > 0
            _close(got.parts[0], want, tol)
    norm = adamw.global_norm(grads)
    assert abs(float(adamw.global_norm(s_grads)) - float(norm)) \
        <= tol * float(norm)


def test_split_step_declares_its_collectives_forward_and_backward():
    """One split training step of reduced minitron-8b over (1, 4) (no
    remat: a recomputed group would declare its forward collectives
    again), counted: the embedding's all-gather on each position and its
    backward's reduce-scatter; two all-reduces a layer on each position,
    and as many in the backward; the loss's three all-reduces of (N,)
    rows on each position (the row max, the float64 sum, the gold logit)
    and none of the logits, forward or backward (no collective as large
    as a position's (B, S, V_i) share); and each ``Placed.take`` of
    another position's shard (the 2 KV heads of 16 columns split 8 a
    position: each position reads half its ``wk`` and ``wv`` columns from
    its neighbour) once forward and once backward, as a
    collective-permute."""
    cfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                              remat=False)
    rows, seq, n = 4, 16, 4
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    params, state, step, _ = train_mod.build(cfg, opt, _mesh((1, n)))
    seen, declare = [], rl.declare_collective

    def record(kind, nbytes, counters=None, device=None):
        seen.append(nbytes)
        return declare(kind, nbytes, counters, device)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rl, "declare_collective", record)
        _, st = rl.count(step, params, state, _batch(cfg, rows, seq))
    act = rows * seq * cfg.d_model * 4
    loss_rows = rows * seq * (4 + 8 + 4)
    piece = cfg.n_layers * cfg.d_model * (cfg.n_kv_heads * cfg.head_dim
                                          // n) * 4
    remote = n * 2        # a piece of wk and of wv on every position
    assert st.collective_counts == {
        "all-gather": n, "reduce-scatter": n,
        "all-reduce": 2 * (2 * cfg.n_layers * n) + 3 * n,
        "collective-permute": 2 * remote}
    assert st.collective_bytes == 2 * (
        n * act + 2 * cfg.n_layers * n * act + remote * piece) \
        + n * loss_rows
    assert max(seen) < rows * seq * (cfg.vocab_size // n) * 4


def assert_steps_match(monkeypatch, cfg, params, mesh_shape, batch):
    """One step of ``launch.train.build`` over ``mesh_shape`` against one
    of the one-position step from the same parameters: loss and
    ``grad_norm`` within 1e-6, and by ``adamw.step_gaps`` the gradients
    AdamW receives within STEP_GRAD_TOL of each leaf's own max|g|, the
    parameters within STEP_PARAM_TOL where the gradient is well above
    AdamW's eps (nearer it the first step turns a rounding of the
    gradient into any share of lr), and every element the one-position
    step moved moved."""
    seen, update = [], adamw.update

    def spy(opt, grads, state, p):
        seen.append(sharding.gather(pytree.tree_map(lambda t: t.clone(),
                                                    grads)))
        return update(opt, grads, state, p)
    monkeypatch.setattr(adamw, "update", spy)
    opt = adamw.AdamWConfig(**OPT)
    start = pytree.tree_map(lambda t: t.clone(), params)
    out = []
    for shape in ((1, 1), mesh_shape):
        p, s, step, _ = train_mod.build(cfg, opt, _mesh(shape), params=(
            pytree.tree_map(lambda t: t.clone(), params)))
        assert sharding.is_split(p) == (shape[1] > 1)
        p, s, m = step(p, s, batch)
        out.append((m, seen[-1], sharding.gather(p)))
    (m1, g1, p1), (m2, g2, p2) = out
    for k in ("loss", "grad_norm"):
        assert abs(float(m2[k]) - float(m1[k])) <= 1e-6 * float(m1[k])
    gaps = adamw.step_gaps(opt, start, g2, p2, g1, p1)
    assert gaps["grad"] <= STEP_GRAD_TOL and gaps["unmoved"] == 0, gaps
    assert gaps["param"] <= STEP_PARAM_TOL, gaps
    return gaps


STEP_CASES = [(arch, (2, 2)) for arch in (SCOUT, VISION, "zamba2-7b",
                                          "whisper-base")] + NEW_SHARES


@pytest.mark.parametrize("arch,mesh_shape", STEP_CASES, ids=[
    arch if shape == (2, 2) else f"{arch}-{shape[0]}x{shape[1]}"
    for arch, shape in STEP_CASES])
def test_split_mesh_step_matches_the_one_position_step(monkeypatch, arch,
                                                       mesh_shape):
    """``launch.train.build`` over (2, 2): each data row's half of the
    batch (and of a VLM's image embeddings, whisper's frames) through its
    split tree, the gradients summed over the rows, AdamW once; and over
    one row of the uneven and empty shares (``NEW_SHARES``); within
    :func:`assert_steps_match`'s limits of the one-position step."""
    cfg = _cfg(arch)
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert_steps_match(monkeypatch, cfg, params, mesh_shape,
                       _batch(cfg, rows=4 * mesh_shape[0]))


def test_replicated_leaf_gradient_is_the_sum_over_positions(monkeypatch):
    """``final_norm`` is replicated: every position reads the one master
    copy. Giving each position a copy of its own shows each position's
    use; their gradients sum to the master's."""
    cfg = get_config("minitron-8b").reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed, _ = _placed(params, (1, 4))
    b = _batch(cfg)
    _, grads = steps.loss_and_grads(placed, b, cfg)
    master = grads["final_norm"]
    assert isinstance(master, Placed) and len(master.parts) == 1
    live = pytree.tree_map(lambda t: t.detach().requires_grad_(), placed)
    target = live["final_norm"]
    copies = [target.parts[0].detach().clone().requires_grad_()
              for _ in range(4)]
    at = Placed.at
    monkeypatch.setattr(Placed, "at", lambda self, i: copies[i]
                        if self is target else at(self, i))
    with torch.enable_grad():
        loss = steps.cross_entropy(
            transformer.forward(live, torch.from_numpy(b["tokens"]), cfg),
            torch.from_numpy(b["targets"]))
        per_position = torch.autograd.grad(loss, copies)
    assert all(float(g.abs().max()) > 0 for g in per_position)
    assert not torch.equal(per_position[0], per_position[1])
    _close(sum(per_position), master.parts[0], 1e-6)


def test_global_norm_counts_each_shard_and_replicated_leaf_once():
    rules = _rules((1, 4))
    split = sharding.place_tensor(torch.arange(32.).reshape(4, 8),
                                  rules.sharding(None, sharding.MLP))
    rep = sharding.place_tensor(torch.full((8,), 2.0), rules.sharding(None))
    tree = {"w": split, "norm": rep}
    assert len(split.parts) == 4 and len(rep.parts) == 1
    assert len(rep.shards) == 4
    want = adamw.global_norm(sharding.gather(tree))
    assert float(adamw.global_norm(tree)) == pytest.approx(float(want),
                                                           rel=1e-7)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("arch", ["minitron-8b", SCOUT, "mamba2-130m"])
def test_checkpoint_of_a_placed_tree_reads_back_unsplit(tmp_path, arch):
    """Also scout's tree: its expert leaves split on the expert dimension,
    the float32 router on its columns, the nested shared expert; and
    mamba2's: ``in_proj`` split on flat columns that straddle its
    segments, the float32 ``A_log``, ``D``, ``dt_bias`` on its heads."""
    cfg = get_config(arch).reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed, rules = _placed(params, (2, 4))
    state = adamw.init(placed)
    ckpt.save(str(tmp_path / "split"), 1, (placed, state))
    ckpt.save(str(tmp_path / "whole"), 1, (params, adamw.init(params)))
    assert _members(tmp_path / "split" / "step_00000001" / "arrays.npz") \
        == _members(tmp_path / "whole" / "step_00000001" / "arrays.npz")
    template = (params, adamw.init(params))
    (got, _), step = ckpt.restore(str(tmp_path / "split"), template,
                                  device="cpu")
    assert step == 1
    for a, b_ in zip(pytree.tree_leaves(got), pytree.tree_leaves(params)):
        assert torch.equal(a, b_)
    places = sharding.param_shardings(params, rules)
    (again, _), _ = ckpt.restore(str(tmp_path / "split"), template,
                                 shardings=(places, {
                                     "m": places, "v": places,
                                     "step": torch.device("cpu")}))
    assert sharding.is_split(again)
    for a, b_ in zip(pytree.tree_leaves(again), pytree.tree_leaves(placed)):
        assert torch.equal(a, b_)
    # a placed template restores onto its own placement
    into, _ = ckpt.restore(str(tmp_path / "split"), (placed, state),
                           device="cpu")
    assert pytree.tree_structure(into) == pytree.tree_structure(
        (placed, state))


def test_recovery_and_elastic_restore_keep_the_placement(tmp_path):
    """``run_with_recovery`` restores a placed state onto its own
    placement after a failure; ``elastic_restore`` with
    ``param_shardings`` splits an unsplit checkpoint onto a new mesh."""
    cfg = get_config("qwen3-32b").reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed, rules = _placed(params, (1, 2))
    failed = []

    def step_fn(state, step):
        if step == 2 and not failed:
            failed.append(step)
            raise RuntimeError("a lost node")
        return pytree.tree_map(lambda t: t + 1.0, state)

    state, log = run_with_recovery(step_fn, placed, 4, str(tmp_path / "r"),
                                   ckpt_every=2)
    assert log["restarts"] == 1 and sharding.is_split(state)
    for a, b_ in zip(pytree.tree_leaves(sharding.gather(state)),
                     pytree.tree_leaves(params)):
        assert torch.equal(a, b_ + 1.0 + 1.0 + 1.0 + 1.0)
    ckpt.save(str(tmp_path / "e"), 3, params)
    got, step = elastic_restore(str(tmp_path / "e"), params, _rules((2, 4)),
                                sharding.param_shardings)
    assert step == 3 and sharding.is_split(got)
    assert got["embed"].devices == [torch.device("cpu")] * 4
    for a, b_ in zip(pytree.tree_leaves(sharding.gather(got)),
                     pytree.tree_leaves(params)):
        assert torch.equal(a, b_)


# ---------------------------------------------------------------------------
# the SSM and hybrid families through the placement entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_ssm_and_hybrid_families_split_over_two_by_two(monkeypatch, arch):
    """The SSM and hybrid families split like every other: ``steps.place``
    on a (2, 2) mesh gives ``Placed`` leaves, ``init_cache`` under its
    rules a ``layers.SplitCache`` over both data rows, ``forward_logits``
    of the placed tree the unsplit logits, and ``launch.train.build`` over
    (2, 2) a split tree whose step matches the one-position step within
    :func:`assert_steps_match`'s limits."""
    cfg = get_config(arch).reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rules = _rules((2, 2))
    placed = steps.place(cfg, params, rules)
    assert all(isinstance(x, Placed) for x in pytree.tree_leaves(
        placed, is_leaf=lambda x: isinstance(x, Placed)))
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, 2, 8, "cpu")
    assert isinstance(cache, layers.SplitCache)
    assert [len(row) for row in cache.rows] == [2, 2]
    tokens = {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}
    _close(steps.forward_logits(placed, tokens, cfg),
           steps.forward_logits(params, tokens, cfg), SPLIT_TOL)
    assert_steps_match(monkeypatch, cfg, params, (2, 2), _batch(cfg, rows=4))
