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
dicts flatten in. A leaf placed along the mesh's ``model`` axis
(``parallel.sharding.Placed``) is saved whole (``.gather()``): the same
bytes as an unsplit save. Restore never requires the saving placement:
each leaf goes where the caller's ``shardings`` tree says (a
``torch.device``, or a ``parallel.sharding.NamedSharding`` as
``param_shardings`` returns, split onto its positions where it splits),
onto the placement of a placed template leaf, or to ``device``.

A bfloat16 leaf is written as the reference writes one (numpy has no
bfloat16; the reference's ``ml_dtypes`` array saves as 2-byte ``<V2``
records): the same bytes and ``.npy`` header in ``arrays.npz``, and
``"dtype": "bfloat16"`` in the manifest. ``restore`` reads the manifest's
dtype and views such a leaf back as ``torch.bfloat16``, bit for bit (the
reference's own restore cannot read it back: ``jax.device_put`` refuses a
``V2`` array).
"""
from __future__ import annotations

import json
import os
import threading
import zipfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.compat import resolve_device
from repro_torch.parallel.sharding import NamedSharding, Placed, place_tensor

_SEP = "/"
BF16 = "bfloat16"
# the .npy descr of an ml_dtypes bfloat16 array, as the reference saves it
_BF16_DESCR = "<V2"


def _key(path) -> str:
    return _SEP.join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)


def _host_array(key: str, leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array of its own and its dtype's name (a tensor on
    the card is copied to the host here, on the caller's thread). A
    bfloat16 leaf becomes its raw 2-byte records."""
    if not isinstance(leaf, torch.Tensor):
        a = np.array(leaf)
        return a, str(a.dtype)
    t = leaf.detach()
    name = None
    if t.dtype == torch.bfloat16:
        t, name = t.view(torch.int16), BF16
    try:
        a = t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    except TypeError as e:
        raise TypeError(f"checkpoint leaf {key!r} has dtype {t.dtype}, which "
                        f"numpy cannot hold; cast it before saving") from e
    return a, name or str(a.dtype)


def _is_placed(x) -> bool:
    return isinstance(x, Placed)


def _flatten(tree) -> dict[str, tuple[np.ndarray, str]]:
    return {_key(path): _host_array(
        _key(path), leaf.gather() if _is_placed(leaf) else leaf)
        for path, leaf in pytree.tree_flatten_with_path(
            tree, is_leaf=_is_placed)[0]}


def _write_npz(path: str, flat: dict[str, tuple[np.ndarray, str]]) -> None:
    """``np.savez``'s archive (uncompressed, one ``<key>.npy`` member per
    leaf), with the reference's ``<V2`` header for a bfloat16 leaf."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (a, name) in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if name != BF16:
                    np.lib.format.write_array(f, a, allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(f, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": a.shape})
                f.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True,
         extra_meta: dict | None = None) -> threading.Thread | None:
    """Write a checkpoint. ``blocking=False`` returns the writer thread
    (async checkpointing: the caller goes on while the host writes); the
    copy of every leaf to the host happens before either returns."""
    flat = _flatten(tree)

    def _write():
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        _write_npz(os.path.join(d, "arrays.npz"), flat)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(a.shape), "dtype": name}
                     for k, (a, name) in flat.items()},
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
    ``torch.device`` or ``NamedSharding``, ``None`` for ``device``) places
    each leaf: pass the current mesh's placements to restore elastically.
    Without one, a placed template leaf is restored onto its own
    placement. ``device=None`` means the CUDA card, raising without one
    (``compat.resolve_device``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    paths, treedef = pytree.tree_flatten_with_path(template,
                                                   is_leaf=_is_placed)
    places = (pytree.tree_leaves(shardings) if shardings is not None
              else [None] * len(paths))
    if len(places) != len(paths):
        raise ValueError(f"shardings has {len(places)} leaves, the template "
                         f"{len(paths)}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["keys"].items()}
    default = None
    leaves = []
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for (path, leaf), place in zip(paths, places):
            if place is None and _is_placed(leaf):
                place = leaf.sharding
            if place is None:
                if default is None:
                    default = resolve_device(device)
                place = default
            key = _key(path)
            if dtypes[key] == BF16:
                t = torch.from_numpy(arrays[key].view(np.int16))
                t = t.view(torch.bfloat16)
            else:
                t = torch.from_numpy(arrays[key])
            leaves.append(place_tensor(t, place)
                          if isinstance(place, NamedSharding)
                          else t.to(place))
    return pytree.tree_unflatten(leaves, treedef), step
