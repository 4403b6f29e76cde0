"""Checkpoints: npz-per-step + JSON manifest, async writes, restore onto
any placement (elastic re-meshing).

Layout (the reference package's, so a checkpoint either package writes
restores bit for bit in the other)::

    <dir>/step_<N>/manifest.json       # step, keys, shapes, dtypes, extra
    <dir>/step_<N>/arrays.npz          # one entry per pytree leaf
    <dir>/LATEST                       # atomic pointer

A leaf's key joins its path's dict keys and sequence indices with ``/``
(``torch.utils._pytree``'s ``MappingKey.key`` and ``SequenceKey.idx``, the
reference's ``DictKey.key`` and ``SequenceKey.idx``), so the keys are the
reference's; ``restore`` looks leaves up by key, whatever order a tree's
dicts flatten in. Restore never requires the saving placement: each leaf
goes where the caller's ``shardings`` tree says (a ``torch.device``), or
to ``device``.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.compat import resolve_device

_SEP = "/"


def _key(path) -> str:
    return _SEP.join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)


def _host_array(key: str, leaf) -> np.ndarray:
    """A leaf as a host array of its own (a tensor on the card is copied
    to the host here, on the caller's thread)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    try:
        return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    except TypeError as e:
        raise TypeError(f"checkpoint leaf {key!r} has dtype {t.dtype}, which "
                        f"numpy cannot hold; cast it before saving") from e


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): _host_array(_key(path), leaf)
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True,
         extra_meta: dict | None = None) -> threading.Thread | None:
    """Write a checkpoint. ``blocking=False`` returns the writer thread
    (async checkpointing: the caller goes on while the host writes); the
    copy of every leaf to the host happens before either returns."""
    flat = _flatten(tree)

    def _write():
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                     for k, v in flat.items()},
            **(extra_meta or {}),
        }
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(f"step_{step:08d}")
        os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip().split("_")[1])


def restore(ckpt_dir: str, template, *, step: int | None = None,
            shardings=None, device=None):
    """Restore into the structure of ``template``; returns ``(tree,
    step)`` with a tensor per leaf. ``shardings`` (a matching tree of
    ``torch.device``, ``None`` for ``device``) places each leaf: pass the
    current mesh's placements to restore elastically. ``device=None``
    means the CUDA card, raising without one (``compat.resolve_device``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    paths, treedef = pytree.tree_flatten_with_path(template)
    places = (pytree.tree_leaves(shardings) if shardings is not None
              else [None] * len(paths))
    if len(places) != len(paths):
        raise ValueError(f"shardings has {len(places)} leaves, the template "
                         f"{len(paths)}")
    default = None
    leaves = []
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for (path, _), place in zip(paths, places):
            if place is None:
                if default is None:
                    default = resolve_device(device)
                place = default
            leaves.append(torch.from_numpy(arrays[_key(path)]).to(place))
    return pytree.tree_unflatten(leaves, treedef), step
