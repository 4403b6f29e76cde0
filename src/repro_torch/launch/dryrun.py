"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake tensors
(port of the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell over 512 placeholder host
devices: one SPMD program split along ``data`` and ``model``, whose
figures are each chip's. The port traces the program one data row of the
production mesh runs: ``lower_cell`` places the parameters with
``train.steps.place`` over the row's ``model`` positions (16), each on a
placeholder device of its own (``meta:0`` .. ``meta:15``; fake tensors,
so nothing is allocated and no card is touched), gives the row its share
of the global batch (``global_batch / dp``; a batch the data positions do
not divide, long_500k's 1, stays whole on the row, as the reference
leaves it unsplit) and runs the train step (``train.steps.make_train_step``,
AdamW over the placed leaves) or the serve steps' prefill or decode into
the row's split cache (``steps.init_cache`` under the row's rules) under
the roofline counter (``launch/roofline.py``), which keeps every figure
per device, so per position.

Per chip: each figure of the fullest position, the largest over the row's
positions, each position counted on its own (``positions`` in the
record; ``fullest_position`` bounds the step): the FLOPs, eager bytes and
temporaries it computes, moves and holds, and the collective bytes it
declares: the tensor-parallel collectives of ``parallel/sharding.py``
(whose emulation on one process counts in the collective term alone) and,
for training, the gradient all-reduce over the data positions, each
position for its own shards. Nothing is divided afterwards. Arguments per
position: the shards it holds, the master copies of the leaves the
placement does not split and the batch share (both on position 0), its
share of the cache (its KV heads, SSM heads and conv channels; the
reference splits a KV cache's sequence over ``model`` instead) and for
training the AdamW state as the reference's ZeRO-1 shards
(``zero1_specs``), so the fullest position's arguments equal the
reference's. Fake tensors keep bf16, so no dtype correction applies
(``bf16_correction`` 1.0; the reference halves its CPU-legalized f32
traffic).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --jobs 6          # cells in 6 processes
Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from repro_torch.compat import Mesh, make_mesh
from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES, applicability
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import abstract_params, input_specs
from repro_torch.launch.train import declare_gradient_reduction
from repro_torch.models.layers import SplitCache
from repro_torch.models.transformer import group_period
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec,
    make_rules,
    use_rules,
    zero1_specs,
)
from repro_torch.train import steps

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def trip_count(cfg: ModelConfig) -> int:
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.n_layers // group_period(cfg)
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return max(1, cfg.n_layers // cfg.shared_attn_every)
    if cfg.family == "audio":
        return cfg.n_layers
    return 1


def _shard_bytes(tree, shardings) -> int:
    """Bytes one position holds of ``tree``, placed by ``shardings``."""
    total = 0
    for leaf, s in zip(pytree.tree_leaves(tree), pytree.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding))):
        n = 1
        for d in s.shard_shape(leaf.shape):
            n *= d
        total += n * leaf.element_size()
    return total


def _storages(tree) -> set[int]:
    return {t.untyped_storage()._cdata for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def row_mesh(mesh) -> Mesh:
    """One data row of ``mesh``: its ``model`` positions over ``("data",
    "model")``, each on a placeholder device of its own (``meta:i``)."""
    n = mesh.shape["model"]
    return make_mesh((1, n), ("data", "model"),
                     devices=[torch.device("meta", i) for i in range(n)])


def row_batch(shape, dp: int) -> int:
    """One data row's share of ``shape``'s global batch: ``1 / dp`` of it,
    or all of it where the ``dp`` data positions do not divide it."""
    b = shape.global_batch
    return b // dp if b % dp == 0 else b


def _bytes_at(tree, devices) -> list[int]:
    """The bytes of ``tree``'s tensors (a placed leaf's parts) on each of
    ``devices``."""
    at = dict.fromkeys(map(str, devices), 0)
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor) and str(t.device) in at:
            at[str(t.device)] += t.numel() * t.element_size()
    return list(at.values())


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_total_steps: int = 10000, cfg: ModelConfig | None = None):
    """Trace one data row of one cell (module doc): ``(stats, memory, cfg,
    shape, mesh, dp, positions)``, with ``stats`` the row's counted run
    (``roofline.StepStats``, per device in ``stats.positions``),
    ``positions`` each ``model`` position's figures (memory in bytes,
    FLOPs, bytes, collective bytes and counts, its roofline step time),
    ``memory`` the per-chip sizes (the largest over the positions) and
    ``dp`` the data positions. ``cfg`` overrides the arch's config (the
    tests trace reduced ones)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="meta")
    rules = make_rules(mesh)
    dp = rules.mesh.size // mesh.shape["model"]
    row = row_mesh(mesh)
    row_rules = make_rules(row)
    devices = list(row.devices.flat)
    batch = row_batch(shape, dp)

    mode = FakeTensorMode()
    aparams = abstract_params(cfg, mode)
    with use_rules(row_rules):
        ins = input_specs(cfg, dataclasses.replace(shape, global_batch=batch),
                          mode, devices[0])
    with mode:
        placed = steps.place(cfg, aparams, row_rules)
    params_at = _bytes_at(placed, devices)

    with mode:
        if shape.kind == "train":
            opt = adamw.AdamWConfig(total_steps=opt_total_steps)
            aopt = adamw.init(placed)
            whole = adamw.init(aparams)
            zero1 = _shard_bytes(whole, pytree.tree_map(
                lambda s: NamedSharding(rules.mesh, s),
                zero1_specs(whole, rules),
                is_leaf=lambda x: isinstance(x, PartitionSpec)))
            alias = [b + zero1 for b in params_at]
            args = [a + b for a, b in zip(alias, _bytes_at(ins, devices))]
            donated = _storages((placed, aopt))
            with rl.Counter() as c:
                p, o, out = steps.make_train_step(cfg, opt)(placed, aopt,
                                                            ins)
                declare_gradient_reduction(placed, dp, rows=1)
        else:
            prefill_fn, decode_fn = steps.make_serve_steps(cfg)
            cache = ins["cache"]
            held = cache.rows if isinstance(cache, SplitCache) else cache
            alias = _bytes_at(held, devices)
            rest = {k: v for k, v in ins.items() if k != "cache"}
            args = [a + b + c for a, b, c in zip(
                params_at, alias, _bytes_at(rest, devices))]
            donated = _storages(held)
            with rl.Counter() as c:
                if shape.kind == "prefill":
                    out = prefill_fn(placed, ins["tokens"], cache,
                                     ins["extras"])
                else:
                    # the position as a host int (the step hands its
                    # eager function a 0-d tensor of it): the step attends
                    # to the whole cache, so its work does not depend on it
                    out = decode_fn(placed, ins["token"], cache, 0,
                                    ins["extras"])
    new = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)
           and t.untyped_storage()._cdata not in donated]
    outs = _bytes_at(new, devices)
    positions = []
    for i, d in enumerate(devices):
        st = c.stats.at(d)
        roof = rl.roofline_from_stats(st, 1, cfg.torch_dtype)
        positions.append({
            "position": i, "argument_size_in_bytes": args[i],
            "output_size_in_bytes": outs[i],
            "temp_size_in_bytes": st.peak_live_bytes,
            "alias_size_in_bytes": alias[i], "flops": st.flops,
            "bytes": st.bytes_accessed,
            "collective_bytes": st.collective_bytes,
            "collective_counts": st.collective_counts,
            "step_time_s": roof.step_time_s})
    memory = {k: max(p[k] for p in positions) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes")}
    return c.stats, memory, cfg, shape, mesh, dp, positions


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, verbose: bool = True,
             cfg: ModelConfig | None = None) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicability(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="SKIP", reason=why)
        _write(rec, out_dir)
        return rec

    t0 = time.time()
    try:
        st, memory, cfg, shape, mesh, dp, positions = lower_cell(
            arch, shape_name, multi_pod, cfg=cfg)
        t_trace = time.time() - t0
        chip = rl.StepStats(
            flops=max(p["flops"] for p in positions),
            bytes_accessed=max(p["bytes"] for p in positions),
            collective_bytes=max(p["collective_bytes"] for p in positions))
        roof = rl.roofline_from_stats(chip, 1, cfg.torch_dtype)
        fullest = max(positions, key=lambda p: p["step_time_s"])
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        model_flops = rl.model_flops(cfg, shape.kind, tokens)
        model_flops_chip = model_flops / mesh.size
        rec.update(
            status="OK",
            trace_s=round(t_trace, 2),
            n_chips=mesh.size, dp_positions=dp,
            model_positions=len(positions),
            row_batch=row_batch(shape, dp),
            per_chip="the largest over the model positions of one data "
                     "row, each traced on a device of its own (module doc)",
            fullest_position=fullest["position"],
            positions=positions,
            memory=memory,
            bytes_per_device_gb=round(max(
                p["argument_size_in_bytes"] + p["output_size_in_bytes"]
                + p["temp_size_in_bytes"] for p in positions) / 2**30, 3),
            trip_count=trip_count(cfg),
            bf16_correction=1.0,
            flops_per_chip=roof.flops,
            bytes_per_chip=roof.bytes,
            collective_bytes_per_chip=roof.collective_bytes,
            collective_counts=fullest["collective_counts"],
            kernels=st.kernels,
            roofline={
                "compute_s": roof.compute_s,
                "memory_s": roof.memory_s,
                "collective_s": roof.collective_s,
                "bound": roof.bound,
                "step_time_s": roof.step_time_s,
                "peak_flops": rl.peak_flops(cfg.torch_dtype),
            },
            model_flops_global=model_flops,
            model_flops_per_chip=model_flops_chip,
            useful_flops_ratio=(model_flops_chip / roof.flops
                                if roof.flops else None),
        )
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] OK "
                  f"trace={t_trace:.1f}s mem/dev="
                  f"{rec['bytes_per_device_gb']}GB bound={roof.bound} "
                  f"step={roof.step_time_s*1e3:.2f}ms", flush=True)
    except Exception as e:  # noqa: BLE001
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] FAIL: {e}",
                  flush=True)
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir: str | None):
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def _run(job: tuple) -> dict:
    return run_cell(*job)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPE_NAMES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    lm_archs = [a for a in list_archs() if a != "vgg16"]
    archs = lm_archs if args.all or not args.arch else [args.arch]
    shapes = list(SHAPE_NAMES) if args.all or not args.shape else [args.shape]

    t0 = time.time()
    jobs = [(arch, shape, mp, args.out) for arch in archs
            for shape in shapes for mp in meshes]
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs) as pool:
            results = pool.map(_run, jobs, chunksize=1)
    else:
        results = [_run(job) for job in jobs]
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n== dry-run: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"of {len(results)} cells in {time.time() - t0:.1f}s ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
