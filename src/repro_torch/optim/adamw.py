"""AdamW with global-norm clipping and a cosine schedule (port of the
reference's ``optim/adamw.py``).

``init`` builds the (m, v, step) state; ``update`` returns (params, state,
metrics). The reference donates params and state to its jitted step, so
here ``update`` writes the params, ``m``, ``v`` and ``step`` in place and
returns the same tensors: at minitron-8b's width the embedding alone is
1.05 G parameters, and each out-of-place fp32 copy of it 4.2 GB. Each leaf
is updated in chunks of ``CHUNK`` elements, so the float32 temporaries
stay small whatever the leaf. The arithmetic is the reference's, step for
step, in float32 tensors on the params' device: the learning rate, the
clip scale and the bias corrections are 0-dim float32 tensors, never
Python floats. A tree placed along the mesh's ``model`` axis
(``parallel.sharding.Placed``) is updated shard by shard, each part on its
own device with those scalars copied there once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

# elements per chunk of the in-place update and of the norm (64 Mi: at most
# a few 256 MiB float32 temporaries at a time)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay: a float32 tensor on ``step``'s
    device."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> dict[str, Any]:
    """Zeroed float32 ``m`` and ``v`` beside each leaf, and ``step`` 0
    (int32) on the first leaf's device."""
    zeros = lambda p: pytree.tree_map(  # noqa: E731
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        p)
    device = pytree.tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _chunks(t: torch.Tensor):
    """Views of ``t`` (contiguous) flattened, ``CHUNK`` elements each."""
    return t.view(-1).split(CHUNK)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed on the
    first leaf's device. A placed tree's leaves are its parts
    (``parallel.sharding.Placed``): each shard counts once and a
    replicated leaf once, not once per position that reads it."""
    leaves = pytree.tree_leaves(tree)
    first = leaves[0].device
    total = 0
    for x in leaves:
        total = total + sum(c.float().square().sum()
                            for c in x.reshape(-1).split(CHUNK)).to(first)
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step, in place: returns ``(params, state, {"grad_norm",
    "lr"})`` holding the same tensors as ``params`` and ``state``, which
    must be contiguous. Decoupled weight decay goes to every leaf with
    ``ndim >= 2``, as in the reference."""
    step = state["step"].add_(1)
    lr = schedule(cfg, step)

    gnorm = global_norm(grads)
    # a true division (a Python scalar over a tensor would multiply by the
    # reciprocal)
    scale = torch.clamp_max(
        torch.full_like(gnorm, cfg.clip_norm) / (gnorm + 1e-9), 1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    scalars = {step.device: (scale, bc1, bc2, lr)}
    leaves = zip(pytree.tree_leaves(params), pytree.tree_leaves(grads),
                 pytree.tree_leaves(state["m"]),
                 pytree.tree_leaves(state["v"]))
    for p, g, m, v in leaves:
        decay = p.ndim >= 2   # decoupled weight decay on matrices only
        if p.device not in scalars:      # a shard on another device
            scalars[p.device] = tuple(t.to(p.device)
                                      for t in scalars[step.device])
        sc, c1, c2, rate = scalars[p.device]
        for pc, gc, mc, vc in zip(_chunks(p), g.reshape(-1).split(CHUNK),
                                  _chunks(m), _chunks(v)):
            gc = gc.float() * sc
            mc.mul_(b1).add_(gc * (1 - b1))
            vc.mul_(b2).add_((gc * (1 - b2)).mul_(gc))
            delta = (mc / c1).div_((vc / c2).sqrt_().add_(cfg.eps))
            if decay:
                delta.add_(cfg.weight_decay * pc.float())
            pc.copy_(pc.float().sub_(rate * delta))
    return params, state, {"grad_norm": gnorm, "lr": lr}


# a gradient element whose clipped size is at most NEAR_EPS * eps lies where
# the first step's update lr * g / (|g| + eps) turns a rounding of g into
# any share of lr; step_gaps holds the parameters only above it
NEAR_EPS = 1e3


@torch.no_grad()
def step_gaps(cfg: AdamWConfig, params, grads, new, ref_grads,
              ref_new) -> dict:
    """How far one AdamW step from ``params`` (``grads`` received, ``new``
    the parameters it gave) lies from a reference step from the same
    parameters and state (``ref_grads``, ``ref_new``); unplaced trees of
    the same structure. ``grad``: the largest over the leaves of max|g -
    g_ref| / max|g_ref| (a leaf whose reference gradient is zero counts
    inf unless its gradient is zero too). ``param``: the largest over the
    leaves of max|p - p_ref| / max(1, max|p_ref|), over the elements whose
    clipped reference gradient exceeds ``NEAR_EPS * eps``. ``unmoved``:
    the elements the reference step moved that this one left as
    ``params`` had them."""
    scale = min(1.0, cfg.clip_norm / (float(global_norm(ref_grads)) + 1e-9))
    grad = param = 0.0
    unmoved = 0
    for p0, g, p, g_ref, p_ref in zip(*(
            pytree.tree_leaves(t) for t in (params, grads, new, ref_grads,
                                            ref_new))):
        p0, g, p, g_ref, p_ref = (t.to(p.device).float()
                                  for t in (p0, g, p, g_ref, p_ref))
        top, diff = float(g_ref.abs().max()), float((g - g_ref).abs().max())
        grad = max(grad, diff / top if top else (0.0 if diff == 0
                                                 else math.inf))
        held = g_ref.abs() * scale > NEAR_EPS * cfg.eps
        if held.any():
            param = max(param, float((p - p_ref).abs()[held].max()) / max(
                1.0, float(p_ref.abs().max())))
        unmoved += int(((p_ref != p0) & (p == p0)).sum())
    return {"grad": grad, "param": param, "unmoved": unmoved}
