"""Model-family dispatch: train step, prefill and decode builders (port of
the reference's ``train/steps.py``).

``make_train_step(cfg, opt)`` returns a :class:`TrainStep` ``(params,
opt_state, batch) -> (params, opt_state, metrics)``: on the card one CUDA
graph per parameter set, captured after its first step and replayed for
every step after it, parameters and optimizer state updated in place (the
reference jits its train step with both donated). ``make_serve_steps``
returns (prefill, decode), the decode a :class:`DecodeStep`: on the card
one CUDA graph a request, captured on its first decode step and replayed
for every token after it (the reference jits its decode step), the
position a 0-d tensor on the device. Every LM family serves and trains:
dense and MoE (``models/transformer.py``), VLM (the same module, with
image embeddings), SSM (mamba2), hybrid (zamba2) and audio (whisper).

Every LM family runs tensor parallel along the mesh's ``model`` axis
(ROADMAP 11i): :func:`place` splits a model's parameters by
``param_shardings`` (heads, hidden units, experts, SSM heads);
:func:`init_cache` under ``use_rules`` of a splitting mesh lays out the
family's cache over it (``layers.SplitCache``); the same functions then
run it tensor parallel (each model module over its ``model`` positions),
with gradients per shard of the same placement; training's loss reads the
logits as the positions' vocabulary shares, where they lie.
"""
from __future__ import annotations

import dataclasses
import itertools
import operator
import threading
import weakref
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.compat import resolve_backend, resolve_device, to_tensor
from repro_torch.configs.base import ModelConfig
from repro_torch.core.executor import (
    STREAMS_PER_WEIGHTS,
    _GraphTable,
    _stream_pool,
    capture_graph,
)
from repro_torch.kernels.common import add_launches
from repro_torch.launch import roofline
from repro_torch.models import mamba2, transformer, whisper, zamba2
from repro_torch.models.layers import SplitCache
from repro_torch.models.layers import params_from_numpy  # noqa: F401
from repro_torch.optim import adamw
from repro_torch.parallel import sharding

# elements of logits per row chunk of ``cross_entropy`` (128 Mi: a 512 MiB
# float32 temporary, 524 rows at vocab 256000)
CE_CHUNK = 1 << 27


FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": mamba2, "hybrid": zamba2, "audio": whisper}


def _family(cfg: ModelConfig):
    """The model module of ``cfg``'s family; a family without one (the
    CNN) raises ``ValueError``, as the reference's dispatch does."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    return FAMILIES[cfg.family]


def place(cfg: ModelConfig, params, rules: sharding.Rules):
    """``params`` placed on ``rules``' mesh by ``param_shardings``:
    per-position shards where the mesh's ``model`` axis spans several
    positions, else every leaf on the mesh's first device."""
    _family(cfg)
    return sharding.place(params, sharding.param_shardings(params, rules))


# ---------------------------------------------------------------------------
# init / forward dispatch
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` on ``device`` (``None``:
    the CUDA card; the generator must live there)."""
    module = _family(cfg)
    return module.init_params(cfg, generator, resolve_device(device))


def forward_logits(params, batch: dict[str, Any], cfg: ModelConfig, *,
                   backend: str = "torch", shares: bool = False):
    """(B, S) ``batch["tokens"]`` -> logits (B, S, V); a VLM also reads
    ``batch["image_embeds"]`` and whisper ``batch["frames"]``. ``backend``
    picks the long-sequence attention, as in :func:`make_serve_steps`.
    With ``shares``, the list of the ``model`` positions' vocabulary
    shares (B, S, V_i), each on its position's device, ungathered (one
    for an unplaced tree): what :func:`cross_entropy` reads in
    training."""
    _family(cfg)
    tokens = batch["tokens"]
    if cfg.family in ("dense", "moe"):
        return transformer.forward(params, tokens, cfg, backend=backend,
                                   shares=shares)
    if cfg.family == "vlm":
        return transformer.forward(params, tokens, cfg,
                                   image_embeds=batch["image_embeds"],
                                   backend=backend, shares=shares)
    if cfg.family == "ssm":
        return mamba2.forward(params, tokens, cfg, shares=shares)
    if cfg.family == "hybrid":
        return zamba2.forward(params, tokens, cfg, backend=backend,
                              shares=shares)
    return whisper.forward(params, tokens, batch["frames"], cfg,
                           backend=backend, shares=shares)


# ---------------------------------------------------------------------------
# loss / train step
# ---------------------------------------------------------------------------

def _chunks(n: int, v: int):
    """The row ranges of ``cross_entropy``'s chunks over (n, v) logits."""
    rows = max(1, CE_CHUNK // v)
    return [(i, min(i + rows, n)) for i in range(0, n, rows)]


def _in_share(targets: torch.Tensor, offset: int, width: int):
    """Each target's column in the share ``[offset, offset + width)``
    (clamped into it) and whether it lies there."""
    col = targets - offset
    return col.clamp(0, width - 1), (col >= 0) & (col < width)


class _CrossEntropy(torch.autograd.Function):
    """Mean next-token cross-entropy over the (N, V_i) vocabulary shares of
    (N, V) logits, each on its ``model`` position's device (one share: the
    whole logits), one chunk of rows at a time: no float32 (N, V_i) tensor
    is ever held, and the backward writes ``softmax - onehot`` chunk by
    chunk into each share's dtype. The reference's scheme over its
    vocabulary-split logits: each position's row max in the logits' dtype,
    then their all-reduced max ``M`` (exact, so each ``(x - M)`` rounds as
    the reference's); each position's float32 sum of ``exp(x - M)`` over
    its columns, all-reduced in float64 and rounded once to float32; the
    gold logit from the share that holds each target (the others give 0),
    all-reduced. Three all-reduces of (N,) rows, and none in the
    backward, where each position writes its own share's gradient. The
    arithmetic is the reference's, rounding point for rounding point:
    ``(logits - M)`` rounded to the logits' dtype before the float32 exp,
    and a gradient of ``exp(s) * (ct / sum)`` rounded to the logits'
    dtype, to which the gold column's ``-ct`` (rounded too) is added."""

    @staticmethod
    def forward(ctx, targets: torch.Tensor, *shares: torch.Tensor):
        n = targets.shape[0]
        offsets = [0, *itertools.accumulate(x.shape[1] for x in shares[:-1])]
        tgts = [targets.to(x.device) for x in shares]
        maxes = []
        for x in shares:
            m = torch.empty(n, dtype=x.dtype, device=x.device)
            for i, j in _chunks(n, x.shape[1]):
                m[i:j] = x[i:j].amax(-1)
            maxes.append(m)
        maxes = sharding.all_reduce_max(maxes)
        sums, golds = [], []
        for x, m, t, o in zip(shares, maxes, tgts, offsets):
            sumexp = torch.empty(n, dtype=torch.float32, device=x.device)
            for i, j in _chunks(n, x.shape[1]):
                shifted = (x[i:j] - m[i:j, None]).float()
                sumexp[i:j] = torch.exp(shifted).sum(-1)
            sums.append(sumexp)
            col, inside = _in_share(t, o, x.shape[1])
            gold = x.gather(1, col[:, None])[:, 0].float()
            golds.append(torch.where(inside, gold, 0.0))
        # the positions' float32 sums added in float64: the all-reduce
        # rounds once, at its end (one share: the sum itself)
        sums = [t.float() for t in sharding.all_reduce_sum(
            [t.double() for t in sums])]
        gold = sharding.all_reduce_sum(golds)[0]
        lse = torch.log(sums[0]) + maxes[0].float()
        ctx.offsets = offsets
        ctx.save_for_backward(*tgts, *shares, *maxes, *sums)
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, grad):
        k = len(ctx.offsets)
        saved = ctx.saved_tensors
        tgts, shares = saved[:k], saved[k:2 * k]
        maxes, sums = saved[2 * k:3 * k], saved[3 * k:]
        n = tgts[0].shape[0]
        ct = grad.float() / n
        outs = []
        for x, t, m, sumexp, o in zip(shares, tgts, maxes, sums,
                                      ctx.offsets):
            ct_x = ct.to(x.device)
            row_ct = ct_x / sumexp
            out = torch.empty_like(x)
            for i, j in _chunks(n, x.shape[1]):
                shifted = (x[i:j] - m[i:j, None]).float()
                out[i:j] = torch.exp(shifted).mul_(row_ct[i:j, None])
            col, inside = _in_share(t, o, x.shape[1])
            idx = torch.arange(n, device=x.device)
            out[idx, col] = out[idx, col] + torch.where(
                inside, (-ct_x).to(out.dtype), 0)
            outs.append(out)
        return (None, *outs)


def cross_entropy(logits, targets: torch.Tensor):
    """Mean next-token CE of the (B, S, V) logits, or of the list of their
    vocabulary shares (B, S, V_i) in column order, each on its position's
    device (``forward_logits(..., shares=True)``), accumulated in float32
    without an fp32 copy of any share and without gathering them; the
    gold logit comes from the share that holds it."""
    shares = [logits] if isinstance(logits, torch.Tensor) else list(logits)
    targets = targets.reshape(-1).long()
    return _CrossEntropy.apply(targets, *(
        x.reshape(targets.shape[0], x.shape[-1]) for x in shares))


def _on_device(batch: dict[str, Any], device: torch.device) -> dict:
    """The batch's arrays or tensors on ``device`` (integers kept)."""
    return {k: to_tensor(b, device) if not isinstance(b, torch.Tensor)
            else b.to(device) for k, b in batch.items()}


@torch.enable_grad()
def loss_and_grads(params, batch: dict[str, Any], cfg: ModelConfig):
    """(loss, grads): the mean CE of ``batch`` and its gradient with respect
    to every leaf of ``params`` (a tree of the same structure: over placed
    parameters, a gradient per shard, and one per replicated leaf's master
    copy, summed over the positions that read it). The batch goes to the
    first leaf's device. Over placed parameters the loss reads each
    position's vocabulary share of the logits where it lies
    (:func:`cross_entropy`): no position holds the whole logits."""
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    batch = _on_device(batch, leaves[0].device)
    shares = forward_logits(pytree.tree_unflatten(live, spec), batch, cfg,
                            shares=True)
    loss = cross_entropy(shares, batch["targets"])
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


class _GraphStep:
    """What the captured step objects (:class:`TrainStep`,
    :class:`DecodeStep`) share: the eager ``fn`` and the ``route`` they
    were built with (:func:`decode_route`), their graphs by key
    (``core.executor._GraphTable``: the stream and the addresses of what a
    graph reads), ``trace_count`` (the captures) and ``last_capture_ms``
    (the last capture's host ms)."""

    WHAT = ""        # the step, and the builder that takes a mesh, for
    BUILT_BY = ""    # the error of a step over several cards

    def __init__(self, cfg: ModelConfig, fn: Callable, route: str):
        self.cfg = cfg
        self.fn = fn
        self.route = route
        self._graphs = _GraphTable(STREAMS_PER_WEIGHTS)
        self._capture_lock = threading.Lock()
        self.trace_count = 0
        self.last_capture_ms = 0.0

    def _graph(self, key, held: list, device: torch.device, stream,
               capture: Callable):
        """``(graph, None)`` with ``key``'s live graph (dead ones dropped
        first), else ``(None, out)`` once ``capture(lock)`` warmed the step
        up and captured it, returning the warm-up's result ``out`` and the
        graph, under this step's capture lock and the stream's ``lock``.
        A step that reads tensors off ``device`` raises ``ValueError``."""
        self._graphs.drop_dead()
        while (g := self._graphs.get(key)) is None:
            away = sorted({str(t.device) for t in held
                           if t.device != device})
            if away:
                raise ValueError(f"a captured {self.WHAT} reads tensors on "
                                 f"{away} besides {device}: build it with "
                                 f"{self.BUILT_BY} for a mesh over several "
                                 f"cards")
            lock = _stream_pool(device, stream).lock
            with self._capture_lock, lock:
                if self._graphs.get(key) is not None:
                    continue         # another thread captured it first
                out, g = capture(lock)
                self._graphs.put(key, g)
                self.trace_count += 1
                return None, out
        return g, None


def _state_leaves(params, opt_state) -> list[torch.Tensor]:
    """Every tensor a train step reads and updates by address: each
    parameter leaf (each part of a ``Placed``) and each AdamW ``m``, ``v``
    and ``step`` leaf."""
    return [t for t in pytree.tree_leaves((params, opt_state))
            if isinstance(t, torch.Tensor)]


@dataclasses.dataclass(eq=False)
class _TrainGraph:
    """One capture of a train step: the graph, its static batch buffers and
    metrics, weak references to the parameter and state leaves it updates
    by address, the cached device constants its capture read, the kernel
    launches it recorded and its stream's lock."""
    graph: "torch.cuda.CUDAGraph"
    batch: dict[str, torch.Tensor]
    metrics: dict[str, torch.Tensor]
    held: tuple
    constants: list
    launches: dict[str, int]
    lock: threading.Lock

    def alive(self) -> bool:
        """Every leaf it was captured over is still referenced outside the
        graph (a dead one may have freed its memory to a new tensor)."""
        return all(ref() is not None for ref in self.held)


class TrainStep(_GraphStep):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"})``, ``params`` and ``opt_state`` updated in place
    and returned: the port's counterpart of the reference's
    ``jax.jit(step, donate_argnums=(0, 1))``. ``fn`` is the eager step.

    On a CUDA device with the route ``"captured"`` (:func:`decode_route`:
    every position on one card) the first call for a parameter set copies
    the batch (numpy arrays or tensors: ``tokens``, ``targets``, a VLM's
    ``image_embeds``, whisper's ``frames``) into static buffers on the card
    and runs ``fn`` on them once (the warm-up: the call's real step, which
    answers it), releases the warm-up's cached temporaries, then captures
    ``fn`` on the same buffers into one ``torch.cuda.CUDAGraph``
    (``core.executor.capture_graph``: the stream's side stream and pool);
    the capture runs nothing, so AdamW's ``step`` counter advances once a
    replay and never at capture. Every later call copies the batch in,
    replays the graph and returns clones of its static metrics. The graph
    reads and writes every parameter and state leaf by address, so it is
    kept per (stream, each batch key's shape and dtype, ``data_ptr`` of
    every leaf) and holds the leaves by weak reference: graphs whose leaves
    died are dropped before every lookup, so parameters restored from a
    checkpoint (new tensors) warm up and capture anew. ``trace_count``
    counts the captures, ``last_capture_ms`` is the last capture's host
    ms. A failed capture raises; nothing falls back to ``fn``.

    ``fn`` runs as it is off CUDA (the CPU, the dry-run's fake and meta
    devices), on the route ``"eager: N cards"``, and while a roofline
    counter is active (``launch.roofline.counting()``): a replay
    dispatches no op, so a counted replay would count nothing."""

    WHAT, BUILT_BY = "train step", "launch.train.build"

    def __call__(self, params, opt_state, batch):
        held = _state_leaves(params, opt_state)
        device = held[0].device
        if (device.type != "cuda" or self.route != "captured"
                or roofline.counting()):
            return self.fn(params, opt_state, batch)
        # the batch as _on_device would make it, still on the host
        host = {k: b if isinstance(b, torch.Tensor) else to_tensor(b, "cpu")
                for k, b in batch.items()}
        stream = torch.cuda.current_stream(device)
        key = (stream.cuda_stream, (
            tuple(t.data_ptr() for t in held),
            tuple((k, tuple(t.shape), t.dtype)
                  for k, t in sorted(host.items()))))
        g, out = self._graph(key, held, device, stream, lambda lock: (
            self._capture(held, params, opt_state, host, device, stream,
                          lock)))
        if g is None:
            return out
        with g.lock:
            for k, t in host.items():
                g.batch[k].copy_(t, non_blocking=True)
            g.graph.replay()
            metrics = {k: v.clone() for k, v in g.metrics.items()}
            add_launches(g.launches)
        return params, opt_state, metrics

    def _capture(self, held, params, opt_state, host: dict,
                 device: torch.device, stream, lock):
        """(the warm-up's result, the graph captured after it)."""
        static = {k: torch.empty(t.shape, dtype=t.dtype,
                                 device=device).copy_(t)
                  for k, t in host.items()}
        # the warm-up on the static batch: its result answers this call
        out = self.fn(params, opt_state, static)
        got = _state_leaves(out[0], out[1])
        if len(got) != len(held) or not all(map(operator.is_, got, held)):
            raise ValueError("a captured train step must update params and "
                             "opt_state in place and return them")
        # the graph's pool takes the step's temporaries: the warm-up's,
        # cached in the default pool, must not stay beside them
        torch.cuda.empty_cache()
        graph, (_, _, metrics), launches, constants, self.last_capture_ms = (
            capture_graph(lambda: self.fn(params, opt_state, static),
                          device, stream))
        return out, _TrainGraph(graph, static, metrics,
                                tuple(weakref.ref(t) for t in held),
                                constants, launches, lock)


def make_train_step(cfg: ModelConfig, opt: adamw.AdamWConfig,
                    mesh=None) -> TrainStep:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``, a :class:`TrainStep` (one CUDA graph
    per parameter set on the card). The step updates ``params`` and
    ``opt_state`` in place (the reference donates both) and returns them;
    the metrics are 0-dim float32 tensors on the params' device. Training
    attention at 2048 tokens and more is the scan, as in the reference.
    ``mesh`` (default: that of the current ``use_rules``, if any) decides
    the route (:func:`decode_route`)."""
    _family(cfg)
    if mesh is None and (rules := sharding.current_rules()) is not None:
        mesh = rules.mesh

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg)
        params, opt_state, om = adamw.update(opt, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    return TrainStep(cfg, train_step, decode_route(mesh))


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """A zeroed cache for ``max_len`` positions on ``device`` (``None``:
    the CUDA card): KV caches, and the SSM's conv and state caches. Under
    ``use_rules`` of a mesh whose ``model`` axis spans several positions,
    a ``layers.SplitCache`` of the family's cache over that mesh;
    ``device`` must then be its first device."""
    _family(cfg)
    device = resolve_device(device)
    make = {
        "ssm": lambda b, d, s: mamba2.init_ssm_cache(cfg, b, d, s),
        "hybrid": lambda b, d, s: zamba2.init_cache(cfg, b, max_len, d, s),
        "audio": lambda b, d, s: whisper.init_cache(cfg, b, max_len, d, s),
    }.get(cfg.family,
          lambda b, d, s: transformer.init_kv_cache(cfg, b, max_len, d, s))
    rules = sharding.current_rules()
    if rules is not None:
        placement = sharding.NamedSharding(rules.mesh, sharding.P())
        if placement.splits:
            if device != placement.device:
                raise ValueError(f"a split cache lives on {rules.mesh!r}; "
                                 f"device {device} is not its first")
            return SplitCache(cfg, batch, placement, make)
    return make(batch, device, None)


def decode_route(mesh=None) -> str:
    """How a decode or train step over ``mesh`` runs on the card, decided
    once when the step is built: ``"captured"`` where every position lies on
    one CUDA device (no mesh, the unsplit (1, 1) mesh, a mesh that
    repeats one card); ``"eager: N cards"`` over N distinct cards (one
    stream's graph cannot span them); ``"eager: <type>"`` on a mesh of
    another device type (the CPU: nothing to capture)."""
    if mesh is None:
        return "captured"
    devices = list(dict.fromkeys(torch.device(d) for d in mesh.devices.flat))
    if devices[0].type != "cuda":
        return f"eager: {devices[0].type}"
    return "captured" if len(devices) == 1 else f"eager: {len(devices)} cards"


def _cache_len(cache) -> int | None:
    """The positions a serving cache holds (None: an SSM cache, which
    holds none)."""
    if isinstance(cache, SplitCache):
        cache = cache.rows[0][0]
    if isinstance(cache, list):              # a transformer's period slots
        return cache[0]["k"].shape[2]
    for name in ("attn_k", "k"):             # zamba2's, whisper's
        if name in cache:
            return cache[name].shape[2]
    return None


def _held(params, cache, extras) -> list[torch.Tensor]:
    """Every tensor a decode step reads by address: each parameter leaf
    (each part of a ``Placed``), each cache leaf (each position's, of a
    ``SplitCache``) and the ``extras`` tensors."""
    rows = cache.rows if isinstance(cache, SplitCache) else cache
    return [t for t in pytree.tree_leaves((params, rows, extras or {}))
            if isinstance(t, torch.Tensor)]


@dataclasses.dataclass(eq=False)
class _DecodeGraph:
    """One capture of a decode step: the graph, its static token, position
    and logits, weak references to the tensors it reads by address, the
    cached device constants its capture read, the kernel launches it
    recorded and its stream's lock."""
    graph: "torch.cuda.CUDAGraph"
    token: torch.Tensor
    pos: torch.Tensor
    logits: torch.Tensor
    held: tuple
    constants: list
    launches: dict[str, int]
    lock: threading.Lock

    def alive(self) -> bool:
        """Every tensor it was captured over is still referenced outside
        the graph. A dead one may have freed its memory, which a new
        tensor may take, so the graph is dropped, never replayed."""
        return all(ref() is not None for ref in self.held)


class DecodeStep(_GraphStep):
    """``decode(params, token, cache, pos, extras=None) -> (logits (B, V),
    cache)``, the cache written in place: the port's counterpart of the
    reference's ``jax.jit(_decode, donate_argnums=(2,))``. ``pos`` is a
    host int; ``fn`` is the eager step, which also takes it as a 0-d
    integer tensor on the device and then reads no position on the host.
    Every call first checks on the host that the positions ``pos ..
    pos + s - 1`` lie in the cache (and in whisper's position table):
    ``ValueError`` before any work.

    On a CUDA device with the route ``"captured"`` (:func:`decode_route`)
    the first call on a stream runs ``fn`` once on a static token buffer
    (B, s) and a static 0-d position tensor (the warm-up, whose result
    answers the call), then captures it into one ``torch.cuda.CUDAGraph``
    (``core.executor.capture_graph``: the stream's side stream and pool);
    every later call copies the token in, sets the position (no host
    sync), replays the graph and returns a clone of its static logits,
    which the caller owns. The graph reads every parameter leaf, cache
    leaf and ``extras`` tensor by address, so it is kept per (stream,
    token shape and dtype, ``data_ptr`` of each) and holds them by weak
    reference: graphs whose referents died are dropped before every
    lookup, so a new cache at a freed cache's address captures anew.
    ``trace_count`` counts the captures, ``last_capture_ms`` is the last
    capture's host ms. A failed capture raises; nothing falls back to
    ``fn``. On the route ``"eager: N cards"`` ``fn`` runs with the host
    int. On any other device (the CPU) ``fn`` runs with the position as a
    0-d tensor: the function the card captures."""

    WHAT, BUILT_BY = "decode step", "make_serve_steps(cfg, mesh=...)"

    def check(self, cache, pos: int, s: int) -> None:
        """``ValueError`` unless positions ``pos .. pos + s - 1`` lie in
        the cache (and in whisper's position table)."""
        if pos < 0:
            raise ValueError(f"decode: position {pos} is negative")
        if self.cfg.family == "audio":
            whisper.check_positions(pos, s)
        n = _cache_len(cache)
        if n is not None and pos + s > n:
            raise ValueError(f"decode: positions up to {pos + s} exceed "
                             f"the cache's {n}")

    def __call__(self, params, token, cache, pos, extras=None):
        pos = operator.index(pos)
        self.check(cache, pos, token.shape[1])
        held = _held(params, cache, extras)
        device = held[0].device
        if device.type != "cuda":
            return self.fn(params, token, cache,
                           torch.tensor(pos, device=device), extras)
        if self.route != "captured":
            return self.fn(params, token, cache, pos, extras)
        stream = torch.cuda.current_stream(device)
        key = (stream.cuda_stream, (tuple(t.data_ptr() for t in held),
                                    tuple(token.shape), token.dtype))
        g, out = self._graph(key, held, device, stream, lambda lock: (
            self._capture(params, token, cache, pos, extras, held, device,
                          stream, lock)))
        if g is None:
            return out
        with g.lock:
            g.token.copy_(token, non_blocking=True)
            g.pos.fill_(pos)
            g.graph.replay()
            logits = g.logits.clone()
            add_launches(g.launches)
        return logits, cache

    def _capture(self, params, token, cache, pos: int, extras, held,
                 device: torch.device, stream, lock):
        """(the warm-up's result, the graph captured after it)."""
        static_token = torch.empty(token.shape, dtype=token.dtype,
                                   device=device)
        static_token.copy_(token)
        static_pos = torch.full((), pos, dtype=torch.int64, device=device)
        # the warm-up on the static inputs: its result answers this call
        out = self.fn(params, static_token, cache, static_pos, extras)
        graph, (logits, _), launches, constants, self.last_capture_ms = (
            capture_graph(lambda: self.fn(params, static_token, cache,
                                          static_pos, extras),
                          device, stream))
        return out, _DecodeGraph(graph, static_token, static_pos, logits,
                                 tuple(weakref.ref(t) for t in held),
                                 constants, launches, lock)


def make_serve_steps(cfg: ModelConfig, backend: str = "torch", mesh=None):
    """Returns (prefill, decode): ``decode(params, token, cache, pos,
    extras=None)`` (a :class:`DecodeStep`, captured as a CUDA graph on
    the card) and ``prefill(params, tokens, cache, extras=None)`` (eager,
    the position a host 0), each -> (last-token logits, cache), run
    without autograd. ``extras`` carries a VLM's ``image_embeds`` and
    whisper's ``enc_out`` (the encoder's states, :func:`whisper.encode`).
    ``backend`` picks the long-sequence attention ("hopper": K6, "torch":
    the scan). ``mesh`` (default: that of the current ``use_rules``, if
    any) decides the decode's route (:func:`decode_route`)."""
    _family(cfg)
    backend = resolve_backend(backend)
    if mesh is None and (rules := sharding.current_rules()) is not None:
        mesh = rules.mesh

    @torch.no_grad()
    def decode(params, token, cache, pos, extras=None):
        extras = extras or {}
        if cfg.family == "ssm":
            return mamba2.decode_step(params, token, cache, pos, cfg)
        if cfg.family == "hybrid":
            return zamba2.decode_step(params, token, cache, pos, cfg,
                                      backend=backend)
        if cfg.family == "audio":
            return whisper.decode_step(params, token, cache, pos,
                                       extras["enc_out"], cfg,
                                       backend=backend)
        return transformer.decode_step(
            params, token, cache, pos, cfg,
            image_embeds=extras.get("image_embeds"), backend=backend)

    step = DecodeStep(cfg, decode, decode_route(mesh))

    def prefill(params, tokens, cache, extras=None):
        step.check(cache, 0, tokens.shape[1])
        return decode(params, tokens, cache, 0, extras)

    return prefill, step
