"""The versioned quantization sidecar, ``hybriddnn-quant/v1``.

A ``QuantSidecar`` is the whole arithmetic contract of a quantized program:
one input scale plus one ``LayerQuant`` per compiled layer (indexed by
``CompiledLayer.layer_id`` == spec index). It lives outside the 128-bit
instruction words, so one ``Program`` serves fp32 and int8. The format and
the digest are the reference's, so ``QuantSidecar.from_dict`` reads a
sidecar written by either package and ``digest()`` joins the program-cache
key: two calibrations of one network never share an entry.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json

import numpy as np
import torch

FORMAT = "hybriddnn-quant/v1"


@dataclasses.dataclass(frozen=True)
class LayerQuant:
    """Per-layer quantization parameters (symmetric, zero point 0).

    ``in_scale``/``out_scale`` dequantize the layer's stored int8 input and
    output (``x_fp ~= x_i8 * scale``); ``wgt_scale`` is a scalar
    (per-tensor) or a tuple of per-output-channel scales; the bias is stored
    int32 at scale ``in_scale * wgt_scale``. ``skip_scale`` is the ELTWISE
    second operand's scale. ``requantize=False`` marks scale-passthrough
    layers (POOL).
    """
    kind: str                       # "conv" | "pool" | "fc" | "eltwise" | "dw"
    in_scale: float
    out_scale: float
    wgt_scale: float | tuple[float, ...] | None = None
    skip_scale: float | None = None
    requantize: bool = True

    @property
    def multiplier(self):
        """int32 accumulator -> int8 output rescale: a float for per-tensor
        weights, a float32 ``(K,)`` vector for per-channel ones — the
        reference's arithmetic, in the same order."""
        if isinstance(self.wgt_scale, (tuple, list)):
            return (np.asarray(self.wgt_scale, np.float32)
                    * np.float32(self.in_scale) / np.float32(self.out_scale))
        return (float(self.in_scale) * float(self.wgt_scale)
                / float(self.out_scale))


@dataclasses.dataclass(frozen=True)
class QuantSidecar:
    input_scale: float
    layers: tuple[LayerQuant, ...]
    observer: str = "percentile"    # provenance, not arithmetic

    # -- (de)serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": FORMAT,
            "observer": self.observer,
            "input_scale": self.input_scale,
            "layers": [dataclasses.asdict(lq) for lq in self.layers],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "QuantSidecar":
        if doc.get("format") != FORMAT:
            raise ValueError(
                f"unsupported quant sidecar format {doc.get('format')!r} "
                f"(this build reads {FORMAT!r})")
        layers = []
        for d in doc["layers"]:
            d = dict(d)
            if isinstance(d.get("wgt_scale"), list):  # per-channel: JSON
                d["wgt_scale"] = tuple(d["wgt_scale"])  # lists -> tuples
            layers.append(LayerQuant(**d))
        return cls(input_scale=float(doc["input_scale"]),
                   layers=tuple(layers),
                   observer=doc.get("observer", "percentile"))

    # -- identity -----------------------------------------------------------
    @functools.cached_property
    def _digests(self) -> dict[str, str]:
        return {}

    def digest(self, schedule_key: str = "") -> str:
        """Content hash; pass a ``Program.schedule_key()`` to bind the
        sidecar to one instruction stream. Memoized per key: the sidecar is
        frozen, and the program cache asks for its digest on every request
        (serializing a full-width VGG16 sidecar takes milliseconds)."""
        out = self._digests.get(schedule_key)
        if out is None:
            js = json.dumps(self.to_dict(), sort_keys=True)
            out = hashlib.sha256(
                (js + "|" + schedule_key).encode()).hexdigest()[:16]
            self._digests[schedule_key] = out
        return out

    # -- network-edge conversions ------------------------------------------
    @property
    def output_scale(self) -> float:
        return float(self.layers[-1].out_scale)

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """fp -> int8 at the network input (round half to even, clip)."""
        from repro_torch.quant.execute import quantize_tensor
        return quantize_tensor(x, self.input_scale)

    def dequantize_output(self, y_i8: torch.Tensor) -> torch.Tensor:
        return y_i8.to(torch.float32) * float(np.float32(self.output_scale))
