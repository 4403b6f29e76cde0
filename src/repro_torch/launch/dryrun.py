"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake tensors
(port of the reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell over 512 placeholder host
devices. The port traces it instead: ``lower_cell`` runs the train step
(``train.steps.make_train_step``, AdamW included) or the serve steps'
prefill or decode on fake tensors (``launch/specs.py``) under the
roofline counter (``launch/roofline.py``), with the production mesh's
rules active over placeholder ``meta`` positions. Nothing is allocated and
no card is touched: the dry-run is the one entry point that runs without a
card, and it never runs a step for real.

Per chip: the trace is the whole global batch on one program, and the
port holds every tensor specced over ``model`` whole (no tensor-parallel
split, so no TP collective is modeled), so each chip's FLOPs, bytes and
temporaries are the traced totals divided over the data-parallel
positions (``pod`` x ``data``); the collective term is the gradient
all-reduce ``launch/train.py``'s mesh step makes over those positions.
Arguments are exact per chip, from the shard shapes of the params
(``param_shardings``), the AdamW state (``zero1_specs``), the batch and
the cache. Fake tensors keep bf16, so no dtype correction applies
(``bf16_correction`` 1.0; the reference halves its CPU-legalized f32
traffic).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES, applicability
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import abstract_params, input_specs
from repro_torch.launch.train import declare_gradient_reduction
from repro_torch.models.transformer import group_period
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec,
    Rules,
    _drop_indivisible,
    make_rules,
    param_shardings,
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


def _batch_shardings(cfg, specs_tree, rules: Rules, batch_leading=True):
    def spec_for(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return rules.sharding()
        logical = [None] * nd
        if batch_leading and leaf.shape[0] > 1:
            logical[0] = "batch"
        return rules.sharding(*logical)
    return pytree.tree_map(spec_for, specs_tree)


def _cache_shardings(cfg: ModelConfig, cache, rules: Rules, batch: int):
    """KV caches: (.., B, S, kv, hd) -> batch over dp, seq over model.
    SSM states: heads over model. Identified by leaf shapes."""
    def spec_for(path, leaf):
        nd = len(leaf.shape)
        key = ""
        for pp in reversed(path):
            k = getattr(pp, "key", None)
            if isinstance(k, str):
                key = k
                break
        logical = [None] * nd
        # find the batch dim (== batch size)
        try:
            bdim = tuple(leaf.shape).index(batch)
        except ValueError:
            bdim = None
        if bdim is not None and batch > 1:
            logical[bdim] = "batch"
        if key in ("k", "v", "attn_k", "attn_v"):
            # (..., B, S, KV, hd): seq dim right after batch
            sdim = (bdim + 1) if bdim is not None else nd - 3
            logical[sdim] = "seq"
        elif key in ("ssm", "groups_ssm", "tail_ssm"):
            logical[-3] = "ssm_heads"       # (..., H, N, P)
        elif key in ("conv", "groups_conv", "tail_conv"):
            logical[-1] = "mlp"             # conv channel dim
        spec = _drop_indivisible(rules.spec(*logical), leaf.shape, rules)
        return NamedSharding(rules.mesh, spec)
    return pytree.tree_map_with_path(spec_for, cache)


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


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_total_steps: int = 10000, cfg: ModelConfig | None = None):
    """Trace one cell: ``(stats, memory, cfg, shape, mesh, dp)``, with
    ``stats`` the counted totals (``roofline.StepStats``), ``memory`` the
    per-chip sizes in bytes and ``dp`` the data positions. ``cfg``
    overrides the arch's config (the tests trace reduced ones)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="meta")
    rules = make_rules(mesh)
    dp = rules.mesh.size // mesh.shape["model"]

    mode = FakeTensorMode()
    aparams = abstract_params(cfg, mode)
    ins = input_specs(cfg, shape, mode)
    args = _shard_bytes(aparams, param_shardings(aparams, rules))

    with use_rules(rules), mode:
        if shape.kind == "train":
            opt = adamw.AdamWConfig(total_steps=opt_total_steps)
            aopt = adamw.init(aparams)
            o_shard = pytree.tree_map(
                lambda s: NamedSharding(rules.mesh, s),
                zero1_specs(aopt, rules),
                is_leaf=lambda x: isinstance(x, PartitionSpec))
            b_bytes = _shard_bytes(ins, _batch_shardings(cfg, ins, rules))
            alias = args + _shard_bytes(aopt, o_shard)
            args = alias + b_bytes
            donated = _storages((aparams, aopt))
            with rl.Counter() as c:
                p, o, out = steps.make_train_step(cfg, opt)(aparams, aopt,
                                                            ins)
                declare_gradient_reduction(aparams, dp)
        else:
            prefill_fn, decode_fn = steps.make_serve_steps(cfg)
            cache = ins["cache"]
            c_bytes = _shard_bytes(cache, _cache_shardings(
                cfg, cache, rules, shape.global_batch))
            rest = {k: v for k, v in ins.items() if k != "cache"}
            args += c_bytes + _shard_bytes(rest, _batch_shardings(
                cfg, rest, rules))
            donated = _storages(cache)
            with rl.Counter() as c:
                if shape.kind == "prefill":
                    out = prefill_fn(aparams, ins["tokens"], cache,
                                     ins["extras"])
                else:
                    # the position as a Python int (the cache slice): the
                    # step attends to the whole cache, so its work does
                    # not depend on it
                    out = decode_fn(aparams, ins["token"], cache, 0,
                                    ins["extras"])
            alias = c_bytes
    new = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)
           and t.untyped_storage()._cdata not in donated]
    memory = {
        "argument_size_in_bytes": args,
        "output_size_in_bytes": sum(t.numel() * t.element_size()
                                    for t in new) // dp,
        "temp_size_in_bytes": c.stats.peak_live_bytes // dp,
        "alias_size_in_bytes": alias,
    }
    return c.stats, memory, cfg, shape, mesh, dp


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
        st, memory, cfg, shape, mesh, dp = lower_cell(
            arch, shape_name, multi_pod, cfg=cfg)
        t_trace = time.time() - t0
        roof = rl.roofline_from_stats(st, dp, cfg.torch_dtype)
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        model_flops = rl.model_flops(cfg, shape.kind, tokens)
        model_flops_chip = model_flops / dp
        rec.update(
            status="OK",
            trace_s=round(t_trace, 2),
            n_chips=mesh.size, dp_positions=dp,
            per_chip="traced totals / dp_positions (model-axis positions "
                     "hold every tensor whole)",
            memory=memory,
            bytes_per_device_gb=round(
                (memory["argument_size_in_bytes"]
                 + memory["output_size_in_bytes"]
                 + memory["temp_size_in_bytes"]) / 2**30, 3),
            trip_count=trip_count(cfg),
            bf16_correction=1.0,
            flops_per_chip=roof.flops,
            bytes_per_chip=roof.bytes,
            collective_bytes_per_chip=roof.collective_bytes,
            collective_counts=st.collective_counts,
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPE_NAMES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    lm_archs = [a for a in list_archs() if a != "vgg16"]
    archs = lm_archs if args.all or not args.arch else [args.arch]
    shapes = list(SHAPE_NAMES) if args.all or not args.shape else [args.shape]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                results.append(run_cell(arch, shape, mp, args.out))
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n== dry-run: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"of {len(results)} cells ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
