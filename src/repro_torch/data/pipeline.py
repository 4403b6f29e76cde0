"""Deterministic synthetic token pipeline — shard-aware, prefetched.

Production posture: every data-parallel shard computes its own slice of the
global batch from a (seed, step, shard) counter-mode PRNG, so (a) no host is
a data bottleneck, (b) restart from checkpoint is bit-exact (the stream is a
pure function of the step), and (c) elastic re-sharding just changes the
shard->rows mapping. A background thread keeps ``prefetch`` batches ahead.
The stream is the reference package's, bit for bit, for every
``(cfg, step, shard, n_shards)``: numpy's Philox generator, no JAX.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    distribution: str = "zipf"   # "zipf" (learnable marginals) | "uniform"


def batch_for_step(cfg: DataConfig, step: int, shard: int = 0,
                   n_shards: int = 1) -> dict[str, np.ndarray]:
    """The shard's rows of the global batch at ``step``. Deterministic."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not divide "
                         f"over {n_shards} shards")
    rows = cfg.global_batch // n_shards
    # counter-mode: seed ^ step ^ shard — independent of process layout
    rng = np.random.Generator(np.random.Philox(
        key=cfg.seed, counter=[0, 0, step, shard]))
    if cfg.distribution == "zipf":
        # skewed marginals: training has signal (uniform tokens cap the
        # achievable loss at ln(V) — nothing to learn)
        raw = rng.geometric(p=min(0.5, 8.0 / cfg.vocab_size),
                            size=(rows, cfg.seq_len + 1)) - 1
        tokens = np.minimum(raw, cfg.vocab_size - 1).astype(np.int32)
    else:
        tokens = rng.integers(0, cfg.vocab_size,
                              size=(rows, cfg.seq_len + 1), dtype=np.int32)
    # next-token LM targets
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


class PrefetchingLoader:
    """Iterator with a background prefetch thread (depth ``prefetch``)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_for_step(self.cfg, step, self.shard, self.n_shards)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
