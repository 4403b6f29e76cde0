"""Tensor parallelism along the mesh's ``model`` axis: the checks
particular to the SSM block (``models/mamba2.py``), on meshes of the
repeated CPU device, in fp32. Serving and training of the SSM, hybrid
and audio families against the unsplit port and the reference are
``tests/test_torch_tensor_parallel.py``'s, with every other family's.

* ``in_proj``'s flat columns split evenly across the z / x / B / C / dt
  segments: each position multiplies by its own shard and takes its SSM
  heads' columns from every position's product; its conv channels,
  ``out_proj`` rows, ``A_log`` and ``norm2`` are its heads'.
* SSM heads that the positions do not divide (8 over 3) serve as
  unsplit, and so do 8 over 16, where every other position holds none
  (it still multiplies by its ``in_proj`` shard, for the others, and
  gives zeros to both all-reduces); attention heads split likewise
  (whisper-base's 8 over 16: one or none), and query heads that
  straddle KV groups carry their place in their first group.
* The collectives a split mamba2 step declares, forward and backward
  (the gated norm's variance and ``out_proj``'s all-reduces, the
  embedding's gather, the loss's three (N,) all-reduces, each piece of a
  layer's ``in_proj``
  product and of the conv a position reads from another position),
  against their sum from the shapes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import layers, mamba2  # noqa: E402
from repro_torch.models.layers import layer_at  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import steps  # noqa: E402

BATCH, PROMPT, N_DECODE = 4, 32, 4
SPLIT_TOL = 1e-5


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


def _serve_run(params, cfg, prompts, toks, cache):
    """Prefill, then decode teacher-forced with ``toks`` (the run's own
    greedy tokens where ``toks`` is empty); the logits and the tokens."""
    prefill, decode = steps.make_serve_steps(cfg)
    logits, cache = prefill(params, torch.from_numpy(prompts), cache)
    out, toks = [logits], list(toks)
    for i in range(N_DECODE):
        if len(toks) <= i:
            toks.append(logits.argmax(-1)[:, None].numpy().astype(np.int32))
        logits, cache = decode(params, torch.from_numpy(toks[i]), cache,
                               PROMPT + i)
        out.append(logits)
    return out, toks


def test_each_position_takes_its_ssm_heads_columns():
    """Reduced mamba2 on 4 positions: ``in_proj``'s 296 flat columns split
    74 a position, across its z / x / B / C / dt segments; position i's
    ``in_proj`` product is the unsplit product's z and x columns of its 2
    SSM heads, every B and C column and its dt columns; its conv holds
    its x channels and every B and C channel, ``out_proj`` its rows."""
    cfg = get_config("mamba2-130m").reduced()
    di, n, h, p = cfg.d_ssm, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    assert (di, n, h, p) == (128, 16, 8, 16)
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed = steps.place(cfg, params, sharding.make_rules(_mesh((1, 4))))
    assert [tuple(t.shape) for t in placed["layers"]["in_proj"].shards] \
        == [(cfg.n_layers, cfg.d_model, 74)] * 4
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    whole = layer_at(params["layers"], 1)
    proj = layers.rms_norm(x, whole["norm"], cfg.norm_eps) @ whole["in_proj"]
    trees = [layer_at(mamba2._position_tree(placed, cfg, i)["layers"], 1)
             for i in range(4)]
    got = mamba2._projections(trees, [x] * 4, cfg)
    for i, tree in enumerate(trees):
        c0, c1 = 2 * i * p, 2 * (i + 1) * p
        cols = [*range(c0, c1), *range(di + c0, di + c1),
                *range(2 * di, 2 * di + 2 * n),
                2 * di + 2 * n + 2 * i, 2 * di + 2 * n + 2 * i + 1]
        assert torch.equal(tree["in_proj"], whole["in_proj"][:, 74 * i:
                                                            74 * (i + 1)])
        torch.testing.assert_close(got[i], proj[..., cols], rtol=0,
                                   atol=1e-6)
        assert torch.equal(tree["conv_w"], whole["conv_w"][
            :, [*range(c0, c1), *range(di, di + 2 * n)]])
        assert torch.equal(tree["out_proj"], whole["out_proj"][c0:c1])
        assert torch.equal(tree["A_log"], whole["A_log"][2 * i:2 * i + 2])
        assert torch.equal(tree["norm2"], whole["norm2"][c0:c1])


def test_uneven_ssm_heads_and_the_shares_that_raise():
    """mamba2's 8 SSM heads over 3 positions (2, 3, 3; ``in_proj``, the
    embedding and the head divide over no 3 and stay master copies from
    which each position cuts its share) serve as unsplit; so do 8 over 16,
    where every even position holds none (its tree keeps ``norm`` and
    ``in_proj`` only, its cache share is empty); whisper-base's 8
    attention heads over 16 positions give one or none. A share of 8
    query heads over 2 KV heads on 3 positions straddles a group: its
    ``q_offset`` is its first head's place in its first group (heads
    [2, 5) over KV heads [0, 2): 2), which ``attention`` pairs by."""
    cfg = get_config("mamba2-130m").reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    whole, toks = _serve_run(params, cfg, prompts, [], steps.init_cache(
        cfg, BATCH, PROMPT + N_DECODE, "cpu"))
    rules = sharding.make_rules(_mesh((1, 3)))
    placed = steps.place(cfg, params, rules)
    assert placed["layers"]["in_proj"].dim is None
    assert [layers._tp_ranges(cfg, 3, i)["ssm_heads"] for i in range(3)] \
        == [(0, 2), (2, 5), (5, 8)]
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, BATCH, PROMPT + N_DECODE, "cpu")
    for got, want in zip(_serve_run(placed, cfg, prompts, toks, cache)[0],
                         whole):
        assert float((got - want).abs().max()) <= SPLIT_TOL * max(
            1.0, float(want.abs().max()))
    rules = sharding.make_rules(_mesh((1, 16)))
    wide = steps.place(cfg, params, rules)
    for i in range(16):
        tree = mamba2._position_tree(wide, cfg, i)["layers"]
        assert ("A_log" in tree) == (i % 2 == 1)
        assert set(tree) >= {"norm", "in_proj"}
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, BATCH, PROMPT + N_DECODE, "cpu")
    assert [tuple(c["conv"].shape[-1:]) + tuple(c["ssm"].shape[-3:-2])
            for c in cache.rows[0][:2]] == [(0, 0), (48, 1)]
    for got, want in zip(_serve_run(wide, cfg, prompts, toks, cache)[0],
                         whole):
        assert float((got - want).abs().max()) <= SPLIT_TOL * max(
            1.0, float(want.abs().max()))
    assert [layers._tp_ranges(get_config("whisper-base"), 16, i)["heads"]
            for i in (0, 1, 14, 15)] == [(0, 0), (0, 1), (7, 7), (7, 8)]
    straddles = layers._tp_ranges(dataclasses.replace(
        get_config("minitron-8b").reduced(), n_heads=8), 3, 1)
    assert (straddles["heads"], straddles["kv_heads"],
            straddles["q_offset"]) == ((2, 5), (0, 2), 2)


def _remote(ranges, width, i, elems):
    """(pieces, bytes) that position ``i`` reads from other positions'
    parts of ``width`` columns for the column ``ranges`` (float32
    elements per column: ``elems``)."""
    pieces = nbytes = 0
    for a, b in ranges:
        for j in range(a // width, (b - 1) // width + 1):
            if j != i:
                pieces += 1
                nbytes += (min(b, (j + 1) * width) - max(a, j * width)) \
                    * elems * 4
    return pieces, nbytes


def test_split_mamba_step_declares_its_collectives_forward_and_backward():
    """One split training step of reduced mamba2 over (1, 2) (no remat),
    counted: per layer and position, the gated norm's all-reduce of the
    (B, L, 1) float32 sums of squares and ``out_proj``'s of the (B, L, d)
    partials, forward and again backward; the embedding's all-gather on
    each position and the head's gather on the first, with their
    backward's reduce-scatters; each piece of a layer's (B, L, 148)
    ``in_proj`` product a position reads from the other's (its z, x, B,
    C and dt columns), and each piece of the stacked ``conv_w`` and
    ``conv_b`` it reads from the other's shard, once forward and once
    backward, as a collective-permute (the SSM heads' ``A_log``, ``D``,
    ``dt_bias`` and ``out_proj`` rows are the position's own shards; no
    piece of ``in_proj`` itself moves); and the loss's three all-reduces
    of (N,) rows on each position (the row max, the float64 sum, the gold
    logit), with no gather of the logits."""
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              remat=False)
    rows, seq, n = 4, 16, 2
    di, ns, p, L = cfg.d_ssm, cfg.ssm_state, cfg.ssm_head_dim, cfg.n_layers
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    params, state, step, _ = train_mod.build(cfg, opt, _mesh((1, n)))
    batch = batch_for_step(DataConfig(cfg.vocab_size, seq, rows), 0)
    _, st = rl.count(step, params, state, batch)
    act = rows * seq * cfg.d_model * 4
    var = rows * seq * 4
    loss_rows = rows * seq * (4 + 8 + 4)
    in_w = (2 * di + 2 * ns + cfg.n_ssm_heads) // n
    conv_w = (di + 2 * ns) // n
    pieces = nbytes = 0
    for i in range(n):
        h0, h1 = layers._tp_ranges(cfg, n, i)["ssm_heads"]
        c0, c1 = h0 * p, h1 * p
        tail = 2 * di + 2 * ns
        for ranges, width, elems, times in (
                ([(c0, c1), (di + c0, di + c1), (2 * di, tail),
                  (tail + h0, tail + h1)], in_w, rows * seq, L),
                ([(c0, c1), (di, di + 2 * ns)], conv_w, L * cfg.ssm_conv, 1),
                ([(c0, c1), (di, di + 2 * ns)], conv_w, L, 1)):
            k, b = _remote(ranges, width, i, elems)
            pieces, nbytes = pieces + times * k, nbytes + times * b
    assert pieces > 0
    assert st.collective_counts == {
        "all-gather": n, "reduce-scatter": n,
        "all-reduce": 2 * (2 * L * n) + 3 * n,
        "collective-permute": 2 * pieces}
    assert st.collective_bytes == 2 * (
        n * act + L * n * (act + var) + nbytes) + n * loss_rows
