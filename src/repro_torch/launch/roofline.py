"""Roofline terms of a step, counted as it runs (port of the reference's
``launch/roofline.py``).

The reference parses compiled HLO; the port has none, so it counts the
aten ops as they run, in a ``TorchDispatchMode`` (:class:`Counter`), on
real or on fake tensors:

* FLOPs        -- every op ``torch.utils.flop_counter`` knows (mm, bmm,
                  addmm, baddbmm, convolution, SDPA, and their backward
                  ops), at its shapes.
* HBM bytes    -- per aten op: operand bytes + result bytes. This is eager,
                  unfused traffic (every elementwise op reads and writes
                  its tensors in full), so it exceeds the reference's
                  post-fusion bytes; views and allocations move nothing.
* Collective bytes -- what the port itself reduces across mesh positions
                  (``launch/train.py``'s gradient reduction and parameter
                  copies, ``optim/compression.compressed_psum``, the
                  tensor-parallel collectives of ``parallel/sharding.py``,
                  forward and backward), declared by that code through
                  :func:`declare_collective`.

Every figure is also kept per device (``StepStats.positions``): an op
counts where its first output lies (else its first operand), a declared
kernel or collective where its caller says, a storage where it was
allocated. Over a mesh of distinct devices (the dry-run's indexed
placeholders) these are the ``model`` positions' own figures. The one
process emulates a collective with adds, concatenations and copies
between the positions' devices; ``parallel/sharding.py`` runs them
:class:`uncounted` and hands their results to :func:`allocated`, so they
count in the collective term alone, and their results as live memory
where they lie.

The hand-written kernels (K1-K6) launch through ``ctypes``, which no
dispatch mode sees: each wrapper declares its work (FLOPs and bytes, from
the one formula per kernel beside it) through :func:`declare_work`, and on
the CPU runs its plain version :func:`uncounted`, so a ``hopper`` step
counts the same on the CPU as on the card.

Every loop runs eagerly and counts every iteration; the reference's
``_loop_multipliers`` gives a loop nested in the layer loop (the scan
attention's KV blocks, the SSD's scan) one trip per layer instead (ROADMAP
Queue 3, "Reference behaviour not copied").

The peaks are the H100 SXM's (NVIDIA data sheet, dense, at the 700 W
limit); ``chip_smoke.py`` reads them from here.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_BF16_FLOPS = 989e12     # bf16 / fp16 on the tensor cores
PEAK_TF32_FLOPS = 494.7e12   # TF32 on the tensor cores
PEAK_FP32_FLOPS = 67e12      # strict fp32 on the FMA pipes (no TF32:
#                              compat.use_strict_fp32)
PEAK_INT8_OPS = 1979e12      # int8 on the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s per direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_ALLOCATIONS = frozenset({
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::detach",
    "aten::lift_fresh", "aten::set_", "aten::resize_",
})
# ops that overwrite their first operand without reading it
_OVERWRITES = frozenset({"aten::copy_", "aten::fill_", "aten::zero_"})
# ops that write rows of their first operand at an index and read none of
# it (a KV cache written at its position): the index, the source read and
# the source's rows written, not the whole operand
_ROW_WRITES = frozenset({"aten::index_copy_"})
_FIRST_UNREAD = _OVERWRITES | _ROW_WRITES


def peak_flops(dtype: torch.dtype) -> float:
    """The card's dense peak for a step computing in ``dtype``."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_BF16_FLOPS
    if dtype == torch.int8:
        return PEAK_INT8_OPS
    return PEAK_FP32_FLOPS


@dataclasses.dataclass
class StepStats:
    """What a counted run did: the reference's ``HLOStats`` fields, plus
    the hand-written kernels' declared work (``kernels``: name ->
    ``{"launches", "flops", "bytes"}``, already inside ``flops`` and
    ``bytes_accessed``), the peak of the bytes allocated during the run
    and still alive (``peak_live_bytes``), and the same figures per
    device (``positions``: ``str(device)`` -> ``StepStats``; the totals
    are their sums, the total peak that of their sum)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    positions: dict = dataclasses.field(default_factory=dict)

    def at(self, device) -> "StepStats":
        """The figures of ``device`` (made on first use)."""
        key = str(device)
        if key not in self.positions:
            self.positions[key] = StepStats()
        return self.positions[key]


_active = threading.local()


def _counters() -> list:
    return getattr(_active, "stack", [])


def counting() -> bool:
    """True while a :class:`Counter` counts on this thread."""
    return bool(_counters())


def declare_work(name: str, flops: float, nbytes: float,
                 device=None) -> None:
    """One launch of hand-written kernel ``name`` on ``device``, doing
    ``flops`` and moving ``nbytes``, into every active counter."""
    for c in _counters():
        for st in (c.stats, c.stats.at(device)):
            k = st.kernels.setdefault(
                name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
            k["launches"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            st.flops += flops
            st.bytes_accessed += nbytes


def declare_collective(kind: str, nbytes: float, counters=None,
                       device=None) -> None:
    """One collective of ``kind`` (one of ``COLLECTIVES``) moving
    ``nbytes`` (the larger of its operand and result) on ``device``'s
    side, into every active counter (or into ``counters``: a backward
    may run on a thread of its own, where none is active)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    for c in _counters() if counters is None else counters:
        for st in (c.stats, c.stats.at(device)):
            st.collective_bytes += nbytes
            st.collective_counts[kind] = st.collective_counts.get(kind, 0) + 1


def active() -> list:
    """The counters active on this thread, for a backward to declare into
    (:func:`declare_collective`'s ``counters``)."""
    return list(_counters())


class uncounted:
    """Within the block no active counter (or none of ``counters``)
    counts aten ops or allocations: a kernel wrapper's plain version,
    whose work the wrapper declared, or a collective's emulation."""

    def __init__(self, counters=None):
        self.counters = counters

    def __enter__(self):
        self._held = list(_counters() if self.counters is None
                          else self.counters)
        for c in self._held:
            c._muted += 1

    def __exit__(self, *exc):
        for c in self._held:
            c._muted -= 1


def allocated(tensors, counters=None) -> None:
    """``tensors`` made uncounted (a collective's results) taken as live
    allocations where they lie, by every active counter (or
    ``counters``), until they die."""
    for c in _counters() if counters is None else counters:
        for t in tensors:
            c._track(t)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts the aten ops run inside it into ``self.stats``
    (:class:`StepStats`), in total and per device; nests with
    ``FakeTensorMode`` (enter the fake mode first). Storages allocated
    inside are tracked until they die, for ``peak_live_bytes``."""

    def __init__(self):
        super().__init__()
        self.stats = StepStats()
        self._muted = 0
        self._live = 0
        self._live_at: dict[str, int] = {}
        self._storages: dict[int, weakref.finalize] = {}

    def __enter__(self):
        _active.stack = [*_counters(), self]
        return super().__enter__()

    def __exit__(self, *exc):
        _active.stack = [c for c in _counters() if c is not self]
        return super().__exit__(*exc)

    def _free(self, key: int, nbytes: int, where: str) -> None:
        self._live -= nbytes
        self._live_at[where] -= nbytes
        self._storages.pop(key, None)

    def _track(self, t: torch.Tensor) -> None:
        """``t``'s storage, new to this counter, alive from now on."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._storages:
            return
        nb, where = storage.nbytes(), str(t.device)
        self._live += nb
        self._live_at[where] = self._live_at.get(where, 0) + nb
        self.stats.peak_live_bytes = max(self.stats.peak_live_bytes,
                                         self._live)
        at = self.stats.at(where)
        at.peak_live_bytes = max(at.peak_live_bytes, self._live_at[where])
        self._storages[key] = weakref.finalize(storage, self._free, key, nb,
                                               where)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._muted or func.namespace != "aten" or func.is_view:
            return out
        name = func._schema.name
        if name in _ALLOCATIONS:
            return out
        outs = _tensors(out)
        operands = _tensors((args, kwargs))
        if not outs and not operands:
            return out
        packet = func.overloadpacket
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        ins = operands[1:] if name in _FIRST_UNREAD else operands
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, (
            operands[-1:] if name in _ROW_WRITES else outs)))
        for st in (self.stats, self.stats.at((outs or operands)[0].device)):
            st.flops += flops
            st.bytes_accessed += nbytes
        # an output into an operand's storage (an in-place op) is no new
        # allocation
        held = {t.untyped_storage()._cdata for t in operands}
        for t in outs:
            if t.untyped_storage()._cdata not in held:
                self._track(t)
        return out


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), StepStats)`` of one counted call."""
    with Counter() as c:
        out = fn(*args, **kwargs)
    return out, c.stats


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes: float
    collective_bytes: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_from_stats(st: StepStats, n_chips: int = 1,
                        dtype: torch.dtype = torch.bfloat16) -> Roofline:
    """The terms of one of ``n_chips`` positions that share the counted
    work evenly (``st`` counts the whole; the reference's stats were
    per chip already), at the card's peak for ``dtype``."""
    flops = st.flops / n_chips
    nbytes = st.bytes_accessed / n_chips
    coll = st.collective_bytes / n_chips
    return Roofline(compute_s=flops / peak_flops(dtype),
                    memory_s=nbytes / HBM_BW,
                    collective_s=coll / NVLINK_BW,
                    flops=flops, bytes=nbytes, collective_bytes=coll)


def model_flops(cfg, kind: str, tokens: int) -> float:
    """The useful work of a step over ``tokens`` tokens: 6 (train) or 2
    (prefill, decode) times the active parameters, per token."""
    return (6 if kind == "train" else 2) * cfg.active_param_count() * tokens
