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
JAX's does; the dry-run's memory per device reads it.

Tensor parallelism runs in one process. :func:`place` puts a parameter
tree where ``param_shardings`` says: over a mesh whose ``model`` axis
spans several positions each leaf becomes a :class:`Placed`, one shard per
``model`` position with ``shard_shape``'s shape on that position's device
(a leaf the spec does not split keeps one master copy on the first
position, which every other position reads through ``.to()``, so
autograd sums its gradient over the positions). Every data row of the mesh
reads its own copy of the shards (:func:`row`; on a repeated device the
copy is the shard itself). The model code computes on plain tensors:
:meth:`Placed.at` gives a position's shard, :meth:`Placed.take` the
columns, rows or experts a position computes with (an MoE layer's
``(G, E, d, f)`` expert leaves split on ``E``, its float32 router on its
expert columns), and :func:`all_reduce_sum`, :func:`all_gather` and
:func:`gather_parts` join the per-position results (and
:func:`all_reduce_max` the cross-entropy's row maxima). Under a roofline
counter (``launch/roofline.py``) each of these, and each read of a master
copy on another device, runs inside an autograd function that declares
its collectives, forward and backward, on each position's side and keeps
its emulation (the adds, concatenations and copies on one process) out
of every position's counted compute, bytes and temporaries. Every LM
family is placed so (``train.steps.place``); this module places whatever
tree it is given.
``shard`` is the identity with or without rules: the split is the
placement's, and a tensor held whole has no constraint to place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np

import torch
from torch.utils import _pytree as pytree

from repro_torch.compat import Mesh
from repro_torch.launch import roofline

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


TP_AXIS = "model"


class NamedSharding:
    """A placement: ``spec`` over ``mesh``, as ``jax.sharding.NamedSharding``.
    ``devices`` are the mesh's distinct devices in position order;
    ``device`` is the first position's, where a tensor held whole lives and
    where the collectives of a split one sum."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.mesh.devices.flat))

    @property
    def device(self) -> torch.device:
        return self.mesh.devices.flat[0]

    def _rows(self) -> "np.ndarray":
        """The mesh's devices as (rows, ``model`` positions): the ``model``
        axis last, every other axis flattened in position order."""
        devs = self.mesh.devices
        if TP_AXIS not in self.mesh.axis_names:
            return devs.reshape(-1, 1)
        m = self.mesh.axis_names.index(TP_AXIS)
        rest = [i for i in range(devs.ndim) if i != m]
        return devs.transpose(rest + [m]).reshape(-1, devs.shape[m])

    @property
    def positions(self) -> int:
        """The number of ``model`` positions."""
        return self.mesh.shape.get(TP_AXIS, 1)

    @property
    def n_rows(self) -> int:
        return self.mesh.size // self.positions

    def row_devices(self, row: int = 0) -> list[torch.device]:
        """The device of each ``model`` position of data row ``row``."""
        return list(self._rows()[row])

    @property
    def splits(self) -> bool:
        """True where :func:`place` holds a tensor as per-position shards:
        the ``model`` axis spans several positions."""
        return self.positions > 1

    def split_dim(self) -> int | None:
        """The dimension the spec splits along ``model`` (None: none); a
        spec naming any other mesh axis raises ``ValueError``."""
        dim = None
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            if entry != TP_AXIS or dim is not None:
                raise ValueError(f"{self!r}: a placement splits one "
                                 f"dimension along {TP_AXIS!r} only")
            dim = d
        return dim

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


def _is_placed(x) -> bool:
    return isinstance(x, Placed)


def param_specs(params, rules: Rules):
    """PartitionSpec tree matching ``params`` (any dict/list tree whose
    leaves have a ``shape``: tensors, ``meta`` tensors and
    :class:`Placed` leaves included)."""
    return pytree.tree_map_with_path(
        lambda path, leaf: _spec_for_path(path, leaf, rules), params,
        is_leaf=_is_placed)


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


# --------------------------------------------------------------------------
# placed trees: per-position shards, and the collectives that join them
# --------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Placed:
    """One leaf held as per-position shards over the ``model`` positions of
    one data row of ``sharding``'s mesh (module doc).

    ``parts`` are what the leaf owns on that row: one shard per position
    where the spec splits a dimension (``dim``), else one master copy on
    the first position. ``shape`` is the global shape. Registered as a
    pytree node whose children are ``parts``, so ``tree_map``,
    ``tree_leaves``, AdamW and the gradient of ``loss_and_grads`` see each
    shard once and a replicated leaf once."""

    def __init__(self, sharding: NamedSharding, shape, parts, row: int = 0):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.parts = list(parts)
        self.row = row
        self.dim = sharding.split_dim()
        self._rows: dict[int, Placed] = {}

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def devices(self) -> list[torch.device]:
        return self.sharding.row_devices(self.row)

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def at(self, i: int) -> torch.Tensor:
        """Position ``i``'s tensor: its shard, or the master read on its
        device (the master itself where the device is the first's)."""
        if self.dim is not None:
            return self.parts[i]
        return _read(self.parts[0], self.devices[i])

    @property
    def shards(self) -> list[torch.Tensor]:
        return [self.at(i) for i in range(self.n)]

    def take(self, dim: int, start: int, stop: int, i: int) -> torch.Tensor:
        """``[start, stop)`` along ``dim`` of the global tensor, on position
        ``i``'s device: position ``i``'s own shard when the range is that
        shard, else assembled from the shards it overlaps (a position that
        computes whole heads reads the columns of another position's; an
        MoE layer's router reads every position's). A leaf held as one
        master copy is cut before it is read on ``i``'s device. Each piece
        read from another position's shard is declared to the roofline's
        collective term, forward and backward, and so is a cut of the
        master read on another device."""
        dim %= self.ndim
        if self.dim is None or dim != self.dim:
            t = self.parts[0] if self.dim is None else self.parts[i]
            if (start, stop) != (0, t.shape[dim]):
                t = t.narrow(dim, start, stop - start)
            return _read(t, self.devices[i])
        return take_parts(self.parts, dim, start, stop, i)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the first position's device."""
        if self.dim is None:
            return self.parts[0]
        first = self.devices[0]
        return torch.cat([p.to(first) for p in self.parts], self.dim)

    def row_copy(self, r: int) -> "Placed":
        """This leaf over data row ``r``'s devices, kept: a shard whose
        device is the same in both rows is the shard itself, any other is
        a copy (:func:`sync_rows` refreshes the copies)."""
        if r == self.row:
            return self
        if r not in self._rows:
            devs = self.sharding.row_devices(r)
            self._rows[r] = Placed(self.sharding, self.shape, [
                p.to(devs[i]) for i, p in enumerate(self.parts)], row=r)
        return self._rows[r]

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.spec!r}, row "
                f"{self.row}, parts {[tuple(p.shape) for p in self.parts]})")


def take_parts(parts: list[torch.Tensor], dim: int, start: int, stop: int,
               i: int) -> torch.Tensor:
    """``[start, stop)`` along ``dim`` of the tensor that ``parts`` split
    evenly along ``dim``, one part a position, on position ``i``'s device
    (``parts[i]``'s): the part itself when the range is it, else assembled
    from the parts it overlaps. Each piece read from another position's
    part is declared to the roofline's collective term as a
    collective-permute, forward and backward. Shards (:meth:`Placed.take`)
    and activations (an SSM block's ``in_proj`` products) alike."""
    dim %= parts[0].ndim
    w = parts[0].shape[dim]
    if (start, stop) == (i * w, (i + 1) * w):
        return parts[i]
    cuts = [(j, max(start, j * w) - j * w, min(stop, (j + 1) * w) - j * w)
            for j in range(start // w, (stop - 1) // w + 1)]
    if roofline.counting():
        return _Take.apply(roofline.active(), dim, cuts, i,
                           parts[i].device, *(parts[j] for j, _, _ in cuts))
    pieces = [parts[j].narrow(dim, lo, hi - lo).to(parts[i].device)
              for j, lo, hi in cuts]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


# --------------------------------------------------------------------------
# the collectives under a roofline counter: the same emulation, run
# uncounted inside autograd functions (forward and backward), so no
# position's compute, bytes or temporaries hold it; each position declares
# its side, and its results count as live memory where they lie
# --------------------------------------------------------------------------

class _Take(torch.autograd.Function):
    """:func:`take_parts`'s assembly of the ``cuts`` ``(j, lo, hi)`` of the
    parts given, on ``device`` (position ``i``'s); backward, each piece's
    gradient back into its part's shape on the part's device."""

    @staticmethod
    def forward(ctx, counters, dim, cuts, i, device, *parts):
        ctx.counters, ctx.dim, ctx.cuts, ctx.i = counters, dim, cuts, i
        ctx.device = device
        ctx.shapes = [(p.shape, p.dtype, p.device, p.element_size())
                      for p in parts]
        with roofline.uncounted(counters):
            pieces = [p.narrow(dim, lo, hi - lo).to(device)
                      for p, (_, lo, hi) in zip(parts, cuts)]
            out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
            if out.untyped_storage()._cdata in {
                    p.untyped_storage()._cdata for p in parts}:
                out = out.clone()       # a function returns no input view
        _declare_pieces(ctx)
        roofline.allocated([out], counters)
        return out

    @staticmethod
    def backward(ctx, grad):
        grads, off = [], 0
        with roofline.uncounted(ctx.counters):
            for (shape, dtype, device, _), (_, lo, hi) in zip(ctx.shapes,
                                                              ctx.cuts):
                g = torch.zeros(shape, dtype=dtype, device=device)
                g.narrow(ctx.dim, lo, hi - lo).copy_(
                    grad.narrow(ctx.dim, off, hi - lo))
                grads.append(g)
                off += hi - lo
        _declare_pieces(ctx)
        roofline.allocated(grads, ctx.counters)
        return (None, None, None, None, None, *grads)


def _declare_pieces(ctx) -> None:
    """A collective-permute for each piece of :class:`_Take` read from
    another position's part, on the reader's side."""
    for (j, lo, hi), (shape, _, _, size) in zip(ctx.cuts, ctx.shapes):
        if j != ctx.i:
            n = (hi - lo) * (int(np.prod(shape)) // shape[ctx.dim])
            roofline.declare_collective("collective-permute", n * size,
                                        ctx.counters, device=ctx.device)


class _Read(torch.autograd.Function):
    """A master copy (or its cut) read on another position's device: a
    collective-permute, forward and backward."""

    @staticmethod
    def forward(ctx, counters, t, device):
        ctx.counters, ctx.src, ctx.device = counters, t.device, device
        ctx.nbytes = _nbytes(t)
        with roofline.uncounted(counters):
            out = t.to(device)
        roofline.declare_collective("collective-permute", ctx.nbytes,
                                    counters, device=device)
        roofline.allocated([out], counters)
        return out

    @staticmethod
    def backward(ctx, grad):
        with roofline.uncounted(ctx.counters):
            g = grad.to(ctx.src)
        roofline.declare_collective("collective-permute", ctx.nbytes,
                                    ctx.counters, device=ctx.device)
        roofline.allocated([g], ctx.counters)
        return None, g, None


def _read(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it lies there, else a copy
    (:class:`_Read` under a roofline counter)."""
    if t.device == device:
        return t
    if roofline.counting():
        return _Read.apply(roofline.active(), t, device)
    return t.to(device)


def _reduce_on_first(parts: list[torch.Tensor],
                  op=torch.add) -> list[torch.Tensor]:
    """``parts`` reduced by ``op`` (a sum by default) in position order on
    the first part's device, then one copy for every further part on its
    device (a clone on the first's device, so no two positions alias)."""
    total = parts[0]
    for p in parts[1:]:
        total = op(total, p.to(total.device))
    return [total] + [total.clone() if p.device == total.device
                      else total.to(p.device) for p in parts[1:]]


class _AllReduce(torch.autograd.Function):
    """:func:`all_reduce_sum` under a counter: every part's all-reduce,
    forward and backward (the outputs' gradients summed the same way and
    handed to every part), each declared on its part's device."""

    @staticmethod
    def forward(ctx, counters, *parts):
        ctx.counters = counters
        ctx.sides = [(_nbytes(p), p.device) for p in parts]
        with roofline.uncounted(counters):
            outs = _reduce_on_first(list(parts))
        _declare_sides(ctx, "all-reduce")
        roofline.allocated(outs, counters)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        with roofline.uncounted(ctx.counters):
            outs = _reduce_on_first([
                torch.zeros(g.shape, dtype=g.dtype, device=d) if g is None
                else g for g, (_, d) in zip(grads, ctx.sides)])
        _declare_sides(ctx, "all-reduce")
        roofline.allocated(outs, ctx.counters)
        return (None, *outs)


def _declare_sides(ctx, kind: str) -> None:
    for nbytes, device in ctx.sides:
        roofline.declare_collective(kind, nbytes, ctx.counters,
                                    device=device)


class _Gather(torch.autograd.Function):
    """The parts concatenated along ``dim`` on each device of ``to`` (one
    output a device): :func:`gather_parts` (the first position's) and
    :func:`all_gather` (every position's). Each output's gather is
    declared where it lies, and backward each part's reduce-scatter of
    the gradient (the outputs' slices summed in order on its device)."""

    @staticmethod
    def forward(ctx, counters, dim, to, *parts):
        ctx.counters, ctx.dim = counters, dim
        ctx.widths = [p.shape[dim] for p in parts]
        ctx.devices = [p.device for p in parts]
        total = sum(map(_nbytes, parts))
        ctx.sides = [(total, d) for d in ctx.devices]
        with roofline.uncounted(counters):
            outs = [torch.cat([p.to(d) for p in parts], dim) for d in to]
        for o in outs:
            roofline.declare_collective("all-gather", _nbytes(o), counters,
                                        device=o.device)
        roofline.allocated(outs, counters)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out, off = [], 0
        with roofline.uncounted(ctx.counters):
            for w, d in zip(ctx.widths, ctx.devices):
                g = None
                for grad in grads:
                    if grad is not None:
                        piece = grad.narrow(ctx.dim, off, w).to(d)
                        g = piece if g is None else g + piece
                out.append(g)
                off += w
        sides = ctx.sides if len(grads) > 1 else ctx.sides[:1]
        for nbytes, device in sides:
            roofline.declare_collective("reduce-scatter", nbytes,
                                        ctx.counters, device=device)
        roofline.allocated([g for g in out if g is not None], ctx.counters)
        return (None, None, None, *out)


def _flatten_placed(x: Placed):
    return x.parts, (x.sharding, x.shape, x.row)


def _unflatten_placed(parts, context) -> Placed:
    sharding, shape, row = context
    return Placed(sharding, shape, parts, row)


pytree.register_pytree_node(
    Placed, _flatten_placed, _unflatten_placed,
    serialized_type_name="repro_torch.parallel.sharding.Placed",
    flatten_with_keys_fn=lambda x: (
        [(pytree.SequenceKey(i), p) for i, p in enumerate(x.parts)],
        (x.sharding, x.shape, x.row)))


def place_tensor(t: torch.Tensor, sharding: NamedSharding):
    """``t`` placed by ``sharding``: a :class:`Placed` of fresh contiguous
    shards (data row 0) where it splits, else ``t`` on its device."""
    if not sharding.splits:
        return t.to(sharding.device)
    dim, devs = sharding.split_dim(), sharding.row_devices(0)

    def fresh(src, device):
        out = torch.empty(src.shape, dtype=src.dtype, device=device)
        return out.copy_(src)

    if dim is None:
        return Placed(sharding, t.shape, [fresh(t, devs[0])])
    w = sharding.shard_shape(t.shape)[dim]
    return Placed(sharding, t.shape, [fresh(t.narrow(dim, i * w, w), d)
                                      for i, d in enumerate(devs)])


@torch.no_grad()
def place(tree, shardings):
    """``tree`` (tensors, or :class:`Placed` leaves gathered first) placed
    by a matching tree of :class:`NamedSharding` (``param_shardings``) or
    ``torch.device``: per-position shards where a placement splits (fresh
    storage), else the tensor on the placement's device (the tensor itself
    where it is there already)."""
    whole = gather(tree)
    flat, spec = pytree.tree_flatten(whole)
    places = pytree.tree_leaves(shardings)
    if len(places) != len(flat):
        raise ValueError(f"shardings has {len(places)} leaves, the tree "
                         f"{len(flat)}")
    return pytree.tree_unflatten(
        [place_tensor(t, s) if isinstance(s, NamedSharding) else t.to(s)
         for t, s in zip(flat, places)], spec)


def is_split(tree) -> bool:
    """True when ``tree`` holds :class:`Placed` leaves."""
    return any(map(_is_placed, pytree.tree_leaves(
        tree, is_leaf=_is_placed)))


def gather(tree):
    """``tree`` with every :class:`Placed` leaf gathered whole on its first
    device (other leaves as they are)."""
    return pytree.tree_map(lambda x: x.gather() if _is_placed(x) else x,
                           tree, is_leaf=_is_placed)


def row(tree, r: int):
    """``tree`` over data row ``r``'s devices (:meth:`Placed.row_copy`)."""
    return pytree.tree_map(lambda x: x.row_copy(r) if _is_placed(x) else x,
                           tree, is_leaf=_is_placed)


@torch.no_grad()
def sync_rows(tree) -> None:
    """Copy each :class:`Placed` leaf's parts into the copies other data
    rows keep (a copy that is the part itself is skipped)."""
    for x in pytree.tree_leaves(tree, is_leaf=_is_placed):
        if not _is_placed(x):
            continue
        for other in x._rows.values():
            for dst, src in zip(other.parts, x.parts):
                if dst is not src:
                    dst.copy_(src)


def all_reduce_sum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the per-position ``parts``, added in position order on
    the first position's device, then one copy for every position on its
    device (a position on the first's device gets a clone, so no two
    positions alias). Autograd follows the ``.to`` and the adds. Under a
    roofline counter each position's all-reduce is declared, and so is
    its backward's (the copies' gradients summed, then handed to every
    part)."""
    if len(parts) == 1:
        return list(parts)
    if roofline.counting():
        return list(_AllReduce.apply(roofline.active(), *parts))
    return _reduce_on_first(parts)


@torch.no_grad()
def all_reduce_max(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise maximum of the per-position ``parts`` (exact in any
    dtype), taken in position order on the first position's device, one
    copy for every position as :func:`all_reduce_sum`'s. No gradient
    flows through it (the cross-entropy's row max, whose gradient the
    loss stops). Under a roofline counter each position's all-reduce is
    declared."""
    if len(parts) == 1:
        return list(parts)
    counting = roofline.counting()
    with roofline.uncounted():
        outs = _reduce_on_first(parts, torch.maximum)
    if counting:
        for p in parts:
            roofline.declare_collective("all-reduce", _nbytes(p),
                                        device=p.device)
        roofline.allocated(outs)
    return outs


def gather_parts(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    """The per-position ``parts`` concatenated along ``dim`` in position
    order on the first position's device (one gather, declared, and its
    backward's reduce-scatter of the gradient to the parts; one part is
    itself)."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0].device
    if roofline.counting():
        return _Gather.apply(roofline.active(), dim, [first], *parts)[0]
    return torch.cat([p.to(first) for p in parts], dim)


def all_gather(parts: list[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """``parts`` concatenated along ``dim`` in position order, one copy on
    each position's device (each position's gather declared, and its
    backward's reduce-scatter: each part's gradient summed over the
    copies; one part is itself)."""
    if len(parts) == 1:
        return list(parts)
    if roofline.counting():
        return list(_Gather.apply(roofline.active(), dim,
                                  [p.device for p in parts], *parts))
    return [torch.cat([q.to(p.device) for q in parts], dim) for p in parts]
