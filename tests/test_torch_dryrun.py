"""``repro_torch.launch.dryrun`` against the reference's, on the CPU.

The reference's dry-run pins 512 placeholder host devices when imported,
so its side runs in one subprocess (as ``tests/test_multidevice.py``
does): ``trip_count`` and the SKIP verdicts of every LM arch, and JAX's
``NamedSharding.shard_shape`` of every parameter leaf over both production
meshes under the reference's rules. The port's shard shapes
(``NamedSharding.shard_shape`` over the placeholder ``meta`` meshes) must
equal them. Reduced ``run_cell``s write ``OK`` records (and a SKIP) to
``tmp_path``, touching no card, with each of the 16 ``model`` positions'
figures; ``lower_cell``'s arguments are each position's placed bytes
(its shards, the master copies and the batch on position 0, its cache
share), the positions' FLOPs sum to the unsplit trace's plus the work
every position repeats (the router, the SSM's B/C products), and serve
cells count their tensor-parallel collectives."""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES, applicability  # noqa: E402,E501
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.specs import abstract_params, input_specs  # noqa: E402,E501
from repro_torch.models import layers  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    NamedSharding,
    P,
    make_rules,
    param_shardings,
)
from repro_torch.train import steps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in list_archs() if a != "vgg16"]


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    """arch -> {"trip", "skip": {shape: reason or None}, "single"/"multi":
    {leaf key: shard shape}} from the reference, 512 host devices."""
    code = textwrap.dedent(f"""
        import json
        import jax
        from repro.launch import dryrun
        from repro.configs.base import get_config
        from repro.configs.shapes import SHAPES, applicability
        from repro.launch.mesh import make_production_mesh
        from repro.launch.specs import abstract_params
        from repro.parallel.sharding import make_rules, param_shardings
        assert len(jax.devices()) == 512
        meshes = {{"single": make_production_mesh(multi_pod=False),
                  "multi": make_production_mesh(multi_pod=True)}}
        def key(path):
            return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                            for p in path)
        out = {{}}
        for arch in {LM_ARCHS!r}:
            cfg = get_config(arch)
            rec = out[arch] = {{"trip": dryrun.trip_count(cfg), "skip": {{
                s: (None if applicability(cfg, SHAPES[s])[0]
                    else applicability(cfg, SHAPES[s])[1])
                for s in SHAPES}}}}
            params = abstract_params(cfg)
            for name, mesh in meshes.items():
                shard = param_shardings(params, make_rules(mesh))
                rec[name] = {{
                    key(p): list(s.shard_shape(l.shape)) for (p, l), s in
                    zip(jax.tree_util.tree_flatten_with_path(params)[0],
                        jax.tree.leaves(shard))}}
        print("JSON" + json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(x for x in r.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_trip_count_and_skips_equal_the_reference(arch):
    ref = _reference()[arch]
    cfg = get_config(arch)
    assert dryrun.trip_count(cfg) == ref["trip"]
    for s in SHAPE_NAMES:
        ok, why = applicability(cfg, SHAPES[s])
        assert (None if ok else why) == ref["skip"][s], s


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shard_shapes_equal_jax(arch, multi_pod):
    want = _reference()[arch]["multi" if multi_pod else "single"]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="meta")
    assert mesh.size == (512 if multi_pod else 256)
    assert set(mesh.devices.flat) == {torch.device("meta")}
    params = abstract_params(get_config(arch))
    shard = param_shardings(params, make_rules(mesh))
    got = {_key(p): list(s.shard_shape(leaf.shape)) for (p, leaf), s in zip(
        pytree.tree_flatten_with_path(params)[0], pytree.tree_leaves(
            shard, is_leaf=lambda x: isinstance(x, NamedSharding)))}
    assert got == want


def test_shard_shape_divides_by_the_named_axes():
    mesh = make_mesh((2, 4, 8), ("pod", "data", "model"),
                     device_type="meta")
    s = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert s.shard_shape((16, 3, 64)) == (2, 3, 8)
    assert NamedSharding(mesh, P()).shard_shape((5, 7)) == (5, 7)
    with pytest.raises(ValueError, match="does not divide"):
        s.shard_shape((12, 3, 64))
    assert s.devices == [torch.device("meta")]
    assert s.device == torch.device("meta")


def _reduced(arch):
    return get_config(arch).reduced()


@pytest.mark.parametrize("arch,shape", [
    ("minitron-8b", "train_4k"), ("minitron-8b", "decode_32k"),
    ("llama-3.2-vision-11b", "prefill_32k"), ("mamba2-130m", "long_500k"),
    ("whisper-base", "decode_32k")])
def test_reduced_run_cell_writes_an_ok_record(tmp_path, arch, shape):
    """A record per chip from the 16 ``model`` positions of one data row:
    each figure the largest over the positions, the collective counts the
    fullest position's. Every position declares two all-reduces a layer
    forward (attention or the SSM's gated norm, and the row-split FFN or
    ``out_proj``); a train cell also each part it holds once, the
    gradient all-reduce over the 16 data positions, and the loss's three
    all-reduces of (N,) rows: its loss reads each position's vocabulary
    share of the logits where it lies, so position 0's temporaries exceed
    the fullest other position's by no more than a few (N,) rows, where
    gathering the logits there would add the (N, V) logits and their
    gradient."""
    cfg = _reduced(arch)
    rec = dryrun.run_cell(arch, shape, False, out_dir=str(tmp_path),
                          verbose=False, cfg=cfg)
    assert rec["status"] == "OK", rec.get("traceback")
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                         .read_text())
    assert on_disk["status"] == "OK"
    assert rec["n_chips"] == 256 and rec["dp_positions"] == 16
    assert rec["model_positions"] == 16 and len(rec["positions"]) == 16
    assert rec["row_batch"] == (1 if shape == "long_500k"
                                else SHAPES[shape].global_batch // 16)
    assert rec["bf16_correction"] == 1.0
    roof = rec["roofline"]
    assert roof["step_time_s"] == max(roof["compute_s"], roof["memory_s"],
                                      roof["collective_s"])
    per = rec["positions"]
    for key, figure in (("flops_per_chip", "flops"),
                        ("bytes_per_chip", "bytes"),
                        ("collective_bytes_per_chip", "collective_bytes")):
        assert rec[key] == max(p[figure] for p in per) > 0
    fullest = per[rec["fullest_position"]]
    assert fullest["step_time_s"] == max(p["step_time_s"] for p in per)
    assert rec["collective_counts"] == fullest["collective_counts"]
    assert 0 < rec["useful_flops_ratio"] <= 1.5
    mem = rec["memory"]
    for key in mem:
        assert mem[key] == max(p[key] for p in per)
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    # all-reduces a layer: the attention's and the FFN's (or the SSM's
    # gated norm and out_proj), whisper's cross-attention's, and a VLM's
    # cross layers' (with image embeddings)
    layers_ = {"audio": 3}.get(cfg.family, 2) * cfg.n_layers
    if cfg.family == "vlm":
        layers_ += cfg.n_layers // cfg.cross_attn_every
    reduces = [p["collective_counts"]["all-reduce"] for p in per]
    if SHAPES[shape].kind == "train":
        mode = FakeTensorMode()
        params = abstract_params(cfg, mode)
        with mode:
            placed = steps.place(cfg, params, make_rules(dryrun.row_mesh(
                make_production_mesh(device_type="meta"))))
        parts = [sum(t.device == torch.device("meta", i)
                     for t in pytree.tree_leaves(placed)) for i in range(16)]
        # the forward's and the backward's two a layer, and those of the
        # forward remat recomputes (checkpointing stops its recompute once
        # it has what the backward reads), the same on every position
        tp = [r - k for r, k in zip(reduces, parts)]
        assert len(set(tp)) == 1 and tp[0] >= 2 * layers_ + 3
        n = rec["row_batch"] * SHAPES[shape].seq_len
        temps = [p["temp_size_in_bytes"] for p in per]
        assert temps[0] <= max(temps[1:]) + 8 * n * 4, temps
        assert n * cfg.vocab_size * 4 > 8 * n * 4
    else:
        assert reduces == [layers_] * 16


def _placed_bytes(cfg, rows):
    """Each position's bytes of the placed parameters over one row of the
    multi-pod mesh, and of its cache share for ``rows`` sequences of
    32768 positions (its KV heads of every layer, K and V, float32)."""
    mode = FakeTensorMode()
    params = abstract_params(cfg, mode)
    row = dryrun.row_mesh(make_production_mesh(multi_pod=True,
                                               device_type="meta"))
    with mode:
        placed = steps.place(cfg, params, make_rules(row))
    out = []
    for i, d in enumerate(row.devices.flat):
        k0, k1 = layers._tp_ranges(cfg, 16, i)["kv_heads"]
        cache = 2 * cfg.n_layers * rows * 32768 * (k1 - k0) * cfg.head_dim
        out.append((sum(t.numel() * 4 for t in pytree.tree_leaves(placed)
                        if t.device == d), 4 * cache))
    return out


def test_run_cell_skips_and_argument_bytes_are_the_shard_shapes(tmp_path):
    """SKIP as the reference; a split decode cell's arguments are each
    position's placed bytes: its shards (with the master copies, on
    position 0, their sum is the reference's shard shapes'), its cache
    share (its KV heads: every fourth position holds one of reduced
    minitron's 2, the others none) and on position 0 the batch share;
    the per-chip figure is the fullest position's."""
    rec = dryrun.run_cell("minitron-8b", "long_500k", True,
                          out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "SKIP" and "quadratic" in rec["reason"]
    assert (tmp_path / "minitron-8b__long_500k__multi.json").exists()
    cfg = _reduced("minitron-8b")
    st, mem, *_, positions = dryrun.lower_cell("minitron-8b", "decode_32k",
                                               True, cfg=cfg)
    rows = 128 // 32
    want = _placed_bytes(cfg, rows)
    params = abstract_params(cfg)
    rules = make_rules(make_production_mesh(multi_pod=True,
                                            device_type="meta"))
    assert want[0][0] == dryrun._shard_bytes(
        params, param_shardings(params, rules))
    assert [c for _, c in want] == [0, 0, 0, want[3][1]] * 4
    batch = 4 * rows + 4            # the tokens and the position
    args = [p + c + (batch if i == 0 else 0)
            for i, (p, c) in enumerate(want)]
    assert [p["argument_size_in_bytes"] for p in positions] == args
    assert [p["alias_size_in_bytes"] for p in positions] == [
        c for _, c in want]
    assert mem["argument_size_in_bytes"] == max(args)
    assert mem["alias_size_in_bytes"] == want[3][1]
    assert st.flops > 0


def _unsplit_flops(cfg, shape_name, rows):
    """The FLOPs of one data row's serve step traced unsplit (every leaf
    whole on one device)."""
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=rows)
    mode = FakeTensorMode()
    params = abstract_params(cfg, mode)
    ins = input_specs(cfg, shape, mode)
    prefill, decode = steps.make_serve_steps(cfg)
    with mode, rl.Counter() as c:
        if shape.kind == "prefill":
            prefill(params, ins["tokens"], ins["cache"], ins["extras"])
        else:
            decode(params, ins["token"], ins["cache"], 0, ins["extras"])
    return c.stats.flops


@pytest.mark.parametrize("arch,shape", [
    ("minitron-8b", "decode_32k"), ("whisper-base", "decode_32k"),
    ("llama4-scout-17b-16e", "prefill_32k"), ("mamba2-130m", "prefill_32k")])
def test_position_flops_sum_to_the_unsplit_trace(arch, shape):
    """The 16 positions' FLOPs sum to the unsplit trace's of the same row
    (heads, hidden units, experts and vocabulary partition the work),
    plus what each position that computes them repeats: the K and V
    projections of a KV head on every position whose query heads read it
    (reduced configs: 4 query heads over 2 KV heads, one head on each of
    4 positions, so each KV head twice; whisper's cross-attention too,
    over its frames), scout's float32 router on every position that holds
    an expert (4 of 16), and mamba2's whole ``in_proj`` product (its 296
    columns divide over no 16, so each position with an SSM head
    multiplies the master copy) and the chunked SSD's ``C B^T`` on each
    of its 8 positions with a head. Norms count no FLOPs. Exact up to
    float rounding (1e-12)."""
    cfg = _reduced(arch)
    st, *_, positions = dryrun.lower_cell(arch, shape, False, cfg=cfg)
    rows = SHAPES[shape].global_batch // 16
    tokens = rows * (1 if SHAPES[shape].kind == "decode"
                     else SHAPES[shape].seq_len)
    extra = 0
    if cfg.n_heads:
        shares = [layers._tp_ranges(cfg, 16, i) for i in range(16)]
        again = sum(k1 - k0 for k0, k1 in (r["kv_heads"] for r in shares)) \
            - cfg.n_kv_heads
        kv_tokens = tokens + (rows * cfg.n_audio_frames
                              if cfg.family == "audio" else 0)
        extra += again * cfg.n_layers * 2 * (2 * kv_tokens * cfg.d_model
                                             * cfg.head_dim)
    if cfg.family == "moe":
        holders = sum(e1 > e0 for e0, e1 in (
            layers._tp_ranges(cfg, 16, i)["experts"] for i in range(16)))
        extra += (holders - 1) * cfg.n_layers * 2 * tokens * cfg.d_model \
            * cfg.n_experts
    if cfg.family == "ssm":
        holders = cfg.n_ssm_heads
        width = 2 * cfg.d_ssm + 2 * cfg.ssm_state + cfg.n_ssm_heads
        chunks = SHAPES[shape].seq_len // 64
        per_layer = (2 * tokens * cfg.d_model * width
                     + 2 * rows * chunks * 64 * 64 * cfg.ssm_state)
        extra += (holders - 1) * cfg.n_layers * per_layer
    total = sum(p["flops"] for p in positions)
    assert total == st.flops
    assert total == pytest.approx(_unsplit_flops(cfg, shape, rows) + extra,
                                  rel=1e-12)


def test_serve_cells_count_their_tensor_parallel_collectives():
    """A reduced minitron decode step over the 16 positions: each
    position all-reduces its (rows, 1, d) attention and FFN partial sums
    once a layer and all-gathers the embedding's columns; the first
    gathers the logits' vocabulary shares; every other position reads the
    master copies of the norms (``norm``, ``norm2``, ``final_norm``) from
    the first, and a position computing a head (every fourth) reads the
    rest of its head's ``wq`` columns and ``wo`` rows (3 pieces of 4,
    split 4 a position) and of its KV head's ``wk`` and ``wv`` columns (7
    pieces of 2) from the positions that hold them, each a
    collective-permute."""
    cfg = _reduced("minitron-8b")
    _, _, *_, positions = dryrun.lower_cell("minitron-8b", "decode_32k",
                                            False, cfg=cfg)
    rows, d, L, f32 = 8, cfg.d_model, cfg.n_layers, 4
    for i, p in enumerate(positions):
        counts = p["collective_counts"]
        head = i % 4 == 3
        assert counts == {
            "all-reduce": 2 * L, "all-gather": 1 + (i == 0),
            **({"collective-permute": 3 * (i > 0) + 20 * head}
               if i else {})}
        gathered = rows * d * f32 + (rows * cfg.vocab_size * f32
                                     if i == 0 else 0)
        reduced = 2 * L * rows * d * f32
        masters = (2 * L * d + d) * f32 if i else 0
        pieces = L * d * f32 * (3 * 4 + 3 * 4 + 7 * 2 + 7 * 2) if head else 0
        assert p["collective_bytes"] == gathered + reduced + masters + pieces


def test_dryrun_cli_writes_records(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "minitron-8b", "--shape", "long_500k",
        "--mesh", "both", "--out", str(tmp_path)])
    assert dryrun.main() == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "minitron-8b__long_500k__multi.json",
        "minitron-8b__long_500k__single.json"]
