"""The assigned input shapes and (arch x shape) cell applicability (port of
the reference's ``configs/shapes.py``, over the port's ``ModelConfig``).

  train_4k     seq 4,096  global_batch 256   -> train_step
  prefill_32k  seq 32,768 global_batch 32    -> serve prefill
  decode_32k   KV len 32,768 global_batch 128 -> serve decode (1 new token)
  long_500k    KV len 524,288 global_batch 1  -> decode; sub-quadratic only

``long_500k`` is SKIPped for pure full-attention archs (a 524k dense KV cache
is the quadratic regime the assignment excludes) and runs for the SSM/hybrid
archs, whose decode state is O(1) in sequence length (DESIGN.md
§Arch-applicability).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def applicability(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if cfg.family == "cnn":
        return (shape.kind == "train", "CNN: image cells only")
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return (False, "full-attention arch: 524k dense KV cache is the "
                       "quadratic regime the assignment excludes")
    return (True, "")


def cells(archs: list[ModelConfig]) -> list[tuple[str, str, bool, str]]:
    """All (arch, shape, runs, reason) rows — 40 for the 10 LM archs."""
    rows = []
    for cfg in archs:
        for sname in SHAPE_NAMES:
            ok, why = applicability(cfg, SHAPES[sname])
            rows.append((cfg.name, sname, ok, why))
    return rows
