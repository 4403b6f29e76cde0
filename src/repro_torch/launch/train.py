"""Training entry point (port of the reference's ``launch/train.py``).

Drives a config end to end: the deterministic data pipeline
(``data.pipeline.batch_for_step``), the train step (``train.steps``: the
chunked cross-entropy, AdamW in place, remat), async checkpointing with
heartbeat monitoring, and restart from the latest checkpoint. It runs on
the CUDA card unless ``device="cpu"`` / ``--device cpu`` is given; the mesh
is the host's (``launch.mesh.make_host_mesh``), which on one card is
``(1, 1)``.

``build`` places the parameters by ``param_shardings`` under the mesh's
rules, as the reference's does (``train.steps.place``): over a mesh whose
``model`` axis spans several positions, every LM family's leaves are
per-position shards (attention and SSM heads, hidden units, experts) and
``loss_and_grads`` runs tensor parallel (ROADMAP 11i).

Over a mesh of several positions (the counterpart of the reference's
jitted step over a ``("data", "model")`` mesh) the step splits the batch on
dim 0 over the data axes (``pod``, ``data``) in position order; each data
row runs ``loss_and_grads`` once, over its own copy of the parameters:
tensor parallel over its ``model`` positions where they are placed, else
whole on the device of its first position. The rows' gradients are summed
in row order on the first row's devices (each shard on its own) and
divided by the row count: the cross-entropy is an unmasked token mean, so
with equal shards that is the whole batch's gradient. Clipping and AdamW
run once, on the first row, and the updated parameters are copied to the
other rows' devices, where those differ (a tree held whole: to every
other distinct device of the mesh, each of which keeps one copy). The
reduction and the copies are declared to the roofline's collective term
(``launch/roofline.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \\
      --reduced --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.checkpoint.fault_tolerance import HeartbeatMonitor
from repro_torch.compat import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import make_rules, use_rules
from repro_torch.train import steps as steps_lib


def data_devices(rules) -> list[torch.device]:
    """The device of each data position, in position order: the first
    position along the other axes of each index over ``rules.dp_axes``."""
    mesh = rules.mesh
    dp = [mesh.axis_names.index(a) for a in rules.dp_axes]
    rest = [i for i in range(mesh.devices.ndim) if i not in dp]
    n = math.prod(mesh.devices.shape[i] for i in dp)
    rows = mesh.devices.transpose(dp + rest).reshape(n, -1)
    return [row[0] for row in rows]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def declare_gradient_reduction(grads, positions: int,
                               rows: int | None = None) -> None:
    """The mesh step's reduction over ``positions`` data positions, to the
    roofline's collective term: each of ``rows`` of them (default: all)
    all-reduces every gradient leaf, each part of a placed leaf on its
    own device."""
    if positions > 1 and roofline.counting():
        for g in pytree.tree_leaves(grads):
            for _ in range(positions if rows is None else rows):
                roofline.declare_collective("all-reduce", _nbytes(g),
                                            device=g.device)


def split_batch(batch: dict, n: int) -> list[dict]:
    """``batch`` split on dim 0 into ``n`` equal shards, in order; a batch
    whose rows do not split evenly raises ``ValueError``."""
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % n:
        raise ValueError(
            f"a batch of {sorted(rows)} rows does not split evenly over "
            f"{n} data positions; the mesh step needs equal shards (the "
            f"loss is a token mean)")
    r = next(iter(rows)) // n
    return [{k: v[i * r:(i + 1) * r] for k, v in batch.items()}
            for i in range(n)]


def _mesh_step(cfg, opt_cfg, rules):
    """The train step over a mesh of several positions (module doc)."""
    row_devices = data_devices(rules)
    n = len(row_devices)
    first = rules.sharding().device
    replicas: dict[torch.device, object] = {}
    synced = [None]      # the params tree the other rows were copied from

    def rows_of(params) -> list:
        """Each data row's parameter tree (the first row's is
        ``params``)."""
        if sharding.is_split(params):
            return [sharding.row(params, r) for r in range(n)]
        replicas[first] = params
        return [replicas[d] for d in row_devices]

    def sync(params) -> None:
        if sharding.is_split(params):
            sharding.sync_rows(params)
            copies = [p for r in range(1, n) for p, q in zip(
                pytree.tree_leaves(sharding.row(params, r)),
                pytree.tree_leaves(params)) if p is not q]
        else:
            copies = []
            for d in rules.sharding().devices[1:]:
                if d not in replicas:
                    replicas[d] = pytree.tree_map(lambda p: p.to(d), params)
                else:
                    pytree.tree_map(lambda r, p: r.copy_(p), replicas[d],
                                    params)
                copies += pytree.tree_leaves(params)
        if roofline.counting():
            for p in copies:
                roofline.declare_collective("all-gather", _nbytes(p),
                                            device=p.device)
        synced[0] = params

    def step(params, opt_state, batch):
        if synced[0] is not params:
            sync(params)
        losses, total, spec = [], None, None
        with use_rules(rules):
            for tree, shard in zip(rows_of(params), split_batch(batch, n)):
                loss, grads = steps_lib.loss_and_grads(tree, shard, cfg)
                losses.append(loss.to(first))
                leaves, g_spec = pytree.tree_flatten(grads)
                if total is None:
                    total, spec = leaves, g_spec
                else:
                    for a, g in zip(total, leaves):
                        a.add_(g.to(a.device))
            grads = pytree.tree_unflatten([g.div_(n) for g in total], spec)
            declare_gradient_reduction(grads, n)
            params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                                 params)
        sync(params)
        return params, opt_state, {"loss": sum(losses) / n, **om}

    return step


def build(cfg, opt_cfg, mesh, seed=0, params=None):
    """(params, opt_state, step_fn, rules) on the mesh's first device:
    ``params`` (a tree there), else random parameters from ``seed`` (a
    torch generator there), placed by ``steps.place`` (a split tree
    is a copy: ``params`` stays as it was), zeroed AdamW state beside
    them, and the train step run under the mesh's rules; over several
    positions the mesh step (module doc), which keeps the other data
    rows' parameter copies. ``step_fn`` is a ``steps.TrainStep`` whose
    route the mesh decides: on one card (the repeated card's meshes
    included) the whole step, the mesh step's reduction and row copies
    too, is one CUDA graph per parameter set, replayed every step; its
    first call for a parameter set runs the step eagerly (the mesh step's
    first copy to the other rows included) and captures it."""
    train_step = steps_lib.make_train_step(cfg, opt_cfg, mesh)  # refuses
    rules = make_rules(mesh)
    device = mesh.devices.flat[0]
    with use_rules(rules):
        if params is None:
            params = steps_lib.init_params(
                cfg, torch.Generator(device=device).manual_seed(seed), device)
        params = steps_lib.place(cfg, params, rules)
        opt_state = adamw.init(params)
    if mesh.size > 1:
        fn = _mesh_step(cfg, opt_cfg, rules)
    else:
        def fn(params, opt_state, batch):
            with use_rules(rules):
                return train_step.fn(params, opt_state, batch)

    return (params, opt_state,
            steps_lib.TrainStep(cfg, fn, train_step.route), rules)


def extras_for(cfg, batch_rows, rng):
    """The stub frontends' inputs (VLM patch and audio frame embeddings),
    float32 draws from ``rng`` cast to the config's dtype."""
    out = {}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch_rows, cfg.n_image_tokens, cfg.d_model), np.float32)
        ).to(cfg.torch_dtype)
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch_rows, cfg.n_audio_frames, cfg.d_model), np.float32)
        ).to(cfg.torch_dtype)
    return out


def train(arch: str, *, reduced: bool = True, steps: int = 20, batch: int = 8,
          seq: int = 64, ckpt_dir: str | None = None, ckpt_every: int = 10,
          lr: float = 1e-3, production_mesh: bool = False,
          resume: bool = True, log_every: int = 5,
          total_steps: int | None = None, device=None) -> list[float]:
    """Train ``steps`` steps (from the latest checkpoint under ``ckpt_dir``
    when ``resume``); returns the losses of the steps run. ``device=None``
    means the CUDA card, raising without one."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    mesh = (make_production_mesh(device_type=dev.type) if production_mesh
            else make_host_mesh(dev.type))
    total_steps = total_steps or steps   # schedule horizon (stable across
    # restarts: a resumed run must pass the ORIGINAL horizon or the cosine
    # schedule, and therefore the training trajectory, changes)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(2, total_steps // 10),
                                total_steps=total_steps)
    params, opt_state, step_fn, rules = build(cfg, opt_cfg, mesh)

    data_cfg = DataConfig(cfg.vocab_size, seq, batch)
    rng = np.random.default_rng(0)
    monitor = HeartbeatMonitor(n_workers=1)

    start = 0
    if ckpt_dir and resume and ckpt_lib.latest_step(ckpt_dir) is not None:
        (params, opt_state), start = ckpt_lib.restore(
            ckpt_dir, (params, opt_state), device=mesh.devices.flat[0])
        print(f"resumed from step {start}")

    print(f"train step: {step_fn.route}")
    losses = []
    pending_ckpt = None
    for step in range(start, steps):
        t0 = time.monotonic()
        b = batch_for_step(data_cfg, step)
        b.update(extras_for(cfg, batch, rng))
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        monitor.report(0, time.monotonic() - t0)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"dt {time.monotonic()-t0:.2f}s")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending_ckpt is not None:
                pending_ckpt.join()
            pending_ckpt = ckpt_lib.save(
                ckpt_dir, step + 1, (params, opt_state), blocking=False)
    if pending_ckpt is not None:
        pending_ckpt.join()
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, (params, opt_state))
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path on the CPU)")
    args = ap.parse_args()
    losses = train(args.arch, reduced=args.reduced, steps=args.steps,
                   batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, lr=args.lr,
                   device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
