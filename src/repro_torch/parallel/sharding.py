"""Mesh axes, partition rules and placements (port of the reference's
``parallel/sharding.py``).

Logical-axis scheme (MaxText-style): every tensor dimension is tagged with
a logical name; ``Rules`` maps logical names to mesh axes. The production
mesh is ``("pod", "data", "model")`` multi-pod or ``("data", "model")``
single-pod: ``pod`` + ``data`` carry data parallelism, ``model`` carries
TP / EP / SP.

The mesh is a :class:`repro_torch.compat.Mesh`; the rules and specs read
only its ``axis_names`` and ``devices.shape``, so they equal the
reference's on any mesh shape, whatever devices it holds.
:class:`PartitionSpec` and :class:`NamedSharding` are the counterparts of
JAX's. ``NamedSharding.shard_shape`` gives the per-position shape, as
JAX's does; the dry-run's memory per device reads it. The port runs a
model in one process and holds every tensor whole on each device that
computes with it (``launch/train.py`` trains over several positions that
way), so a :class:`NamedSharding` resolves to one ``torch.device`` only
where the mesh holds one distinct device. Placing the shards of one tensor
over several devices (tensor parallelism) is ROADMAP Queue 1, item 11i.
``shard`` is therefore the identity with or without rules: a tensor held
whole has no constraint to place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
from torch.utils import _pytree as pytree

from repro_torch.compat import Mesh

# logical axis names
BATCH = "batch"        # -> (pod, data)
SEQ = "seq"            # -> model (sequence parallelism for caches/long ctx)
EMBED = "embed"        # -> None (replicated d_model)
HEADS = "heads"        # -> model (TP over attention heads)
KV_HEADS = "kv_heads"  # -> model
MLP = "mlp"            # -> model (TP over FFN hidden)
VOCAB = "vocab"        # -> model (TP over vocab/logits)
EXPERT = "expert"      # -> model (EP)
STACK = "stack"        # -> None (scan-stacked layer dim)
SSM_HEADS = "ssm_heads"
CONV = "conv"


class PartitionSpec(tuple):
    """One entry per dimension: ``None`` (replicated), a mesh axis name, or
    a tuple of names (sharded over their product), as
    ``jax.sharding.PartitionSpec``; a tuple of one name is that name."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A placement: ``spec`` over ``mesh``, as ``jax.sharding.NamedSharding``.
    ``devices`` are the mesh's distinct devices in position order;
    ``device`` is the one torch device it puts a whole tensor on."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.mesh.devices.flat))

    @property
    def device(self) -> torch.device:
        distinct = self.devices
        if len(distinct) != 1:
            raise NotImplementedError(
                f"{self!r} spans {len(distinct)} devices; placing the shards "
                f"of one tensor over several devices in one process is not "
                f"ported (ROADMAP Queue 1, item 11i)")
        return distinct[0]

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """The shape each position holds of a ``global_shape`` tensor:
        every dimension divided by the size of the mesh axes its spec
        entry names, as ``jax.sharding.NamedSharding.shard_shape``; a
        dimension they do not divide raises ``ValueError``."""
        sizes = self.mesh.shape
        out = list(global_shape)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            n = 1
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                n *= sizes[axis]
            if out[dim] % n:
                raise ValueError(f"{self!r}: dimension {dim} of "
                                 f"{tuple(global_shape)} does not divide "
                                 f"over {n} positions")
            out[dim] //= n
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Mesh
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"

    def spec(self, *logical: str | None) -> PartitionSpec:
        parts = []
        for name in logical:
            if name is None:
                parts.append(None)
            elif name == BATCH:
                parts.append(self.dp_axes if len(self.dp_axes) > 1
                             else self.dp_axes[0])
            elif name in (SEQ, HEADS, KV_HEADS, MLP, VOCAB, EXPERT, SSM_HEADS):
                parts.append(self.tp_axis)
            elif name in (EMBED, STACK, CONV):
                parts.append(None)
            else:
                raise ValueError(f"unknown logical axis {name!r}")
        return P(*parts)

    def sharding(self, *logical: str | None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(*logical))


def make_rules(mesh: Mesh) -> Rules:
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return Rules(mesh=mesh, dp_axes=dp or (mesh.axis_names[0],))


# --------------------------------------------------------------------------
# active-rules context (thread-local so model code stays pure-looking)
# --------------------------------------------------------------------------

_state = threading.local()


def current_rules() -> Rules | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Rules | None):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """``x`` itself, with no copy: the reference's sharding constraint has
    nothing to place on one device. Under active rules the logical names
    are still checked (an unknown one raises, as in the reference)."""
    rules = current_rules()
    if rules is not None:
        rules.spec(*logical)
    return x


# --------------------------------------------------------------------------
# parameter partition specs (path-based rules over the params tree)
# --------------------------------------------------------------------------

# leaf-name -> logical axes per dimension, EXCLUDING the leading stack dim
# which is added automatically for stacked leaves.
_PARAM_RULES: dict[str, tuple[str | None, ...]] = {
    "embed": (None, MLP),   # d-sharded: token take() stays local; a
                         # vocab-sharded table all-gathers 2-4GB/step
    "lm_head": (None, VOCAB),
    "pos_embed": (None, None),
    "wq": (None, HEADS),
    "wk": (None, KV_HEADS),
    "wv": (None, KV_HEADS),
    "wo": (HEADS, None),
    "bq": (HEADS,), "bk": (KV_HEADS,), "bv": (KV_HEADS,), "bo": (None,),
    "q_norm": (None,),
    "k_norm": (None,),
    "w_gate": (None, MLP),
    "w_up": (None, MLP),
    "w_down": (MLP, None),
    "w_in": (None, MLP),
    "w_out": (MLP, None),
    "b_in": (MLP,), "b_out": (None,),
    # MoE: leading expert dim
    "we_gate": (EXPERT, None, None),
    "we_up": (EXPERT, None, None),
    "we_down": (EXPERT, None, None),
    "router": (None, EXPERT),
    # mamba2 / SSD
    "in_proj": (None, MLP),
    "out_proj": (MLP, None),
    "conv_w": (None, MLP),
    "conv_b": (MLP,),
    "A_log": (SSM_HEADS,),
    "D": (SSM_HEADS,),
    "dt_bias": (SSM_HEADS,),
    "norm": (None,),
    "norm2": (None,),
    "norm3": (None,),
    "final_norm": (None,),
    "enc_norm": (None,),
    "scale": (None,),
}


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _axes_size(rules: Rules, entry) -> int:
    sizes = dict(zip(rules.mesh.axis_names, rules.mesh.devices.shape))
    axes = entry if isinstance(entry, tuple) else (entry,)
    total = 1
    for a in axes:
        total *= sizes[a]
    return total


def _drop_indivisible(spec: PartitionSpec, shape, rules: Rules
                      ) -> PartitionSpec:
    """Drop the axes whose size does not divide their dimension."""
    return P(*(entry if entry is None
               or shape[dim] % _axes_size(rules, entry) == 0 else None
               for dim, entry in enumerate(spec)))


def _ndim(leaf) -> int:
    return leaf.ndim if hasattr(leaf, "ndim") else len(leaf.shape)


def _spec_for_path(path, leaf, rules: Rules) -> PartitionSpec:
    name = None
    for entry in reversed(path):
        key = getattr(entry, "key", getattr(entry, "name", None))
        if isinstance(key, str):
            name = key
            break
    if name is None or name not in _PARAM_RULES:
        return P()
    logical = _PARAM_RULES[name]
    ndim = _ndim(leaf)
    if ndim == len(logical) + 1:      # stacked leaf: leading group dim
        logical = (None,) + logical
    elif ndim == len(logical) + 2:    # stacked + grouped (e.g. vlm groups)
        logical = (None, None) + logical
    elif ndim != len(logical):
        return P()
    return _drop_indivisible(rules.spec(*logical), leaf.shape, rules)


def param_specs(params, rules: Rules):
    """PartitionSpec tree matching ``params`` (any dict/list tree whose
    leaves have a ``shape``: tensors, ``meta`` tensors included)."""
    return pytree.tree_map_with_path(
        lambda path, leaf: _spec_for_path(path, leaf, rules), params)


def param_shardings(params, rules: Rules):
    return pytree.tree_map(lambda spec: NamedSharding(rules.mesh, spec),
                           param_specs(params, rules), is_leaf=_is_spec)


def zero1_specs(params, rules: Rules):
    """ZeRO-1 optimizer-state specs: param spec + DP sharding on dim 0.

    The AdamW m/v tensors are additionally sharded over the data axes along
    their first dimension where it divides, so optimizer state scales with
    1/(pod*data) on a mesh of distinct devices."""
    dp = rules.dp_axes

    def widen(spec: PartitionSpec, leaf) -> PartitionSpec:
        ndim = _ndim(leaf)
        if ndim == 0:
            return P()
        parts = list(spec) + [None] * (ndim - len(spec))
        d0 = parts[0]
        if d0 is None:
            cand = dp if len(dp) > 1 else dp[0]
        elif isinstance(d0, str):
            cand = (d0,) + dp
        else:
            cand = tuple(d0) + dp
        if leaf.shape[0] % _axes_size(rules, cand) == 0:
            parts[0] = cand
        return _drop_indivisible(P(*parts), leaf.shape, rules)

    return pytree.tree_map(widen, param_specs(params, rules), params,
                           is_leaf=_is_spec)
