"""Post-training calibration: fp32 replay + range observation -> sidecar.

Replays the spec chain in fp32 with the same stash-based walk as
``models.resnet.reference_forward`` (``replay_stash``), so every topology
the compiler accepts calibrates, ``inp_from`` forks and ``skip_from``
residuals included, and feeds one observer per produced tensor. Weight
scales come straight from ``|w|_max`` per output channel for CONV/FC and
per tensor for DEPTHWISE; POOL layers are pinned to scale passthrough
(``max()`` commutes with a positive rescale, so the pooled int8 map is the
pooled fp map quantized at the input scale). The scale arithmetic is the
reference's, in numpy on host copies: equal weights give bit-equal weight
scales, and activation scales differ only by the last bits of the fp32
replay.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.compat import to_numpy, to_tensor
from repro_torch.core.hybrid_conv import (
    ConvSpec,
    DepthwiseSpec,
    EltwiseSpec,
    FCSpec,
    PoolSpec,
)
from repro_torch.optim.compression import quantize_int8
from repro_torch.quant.execute import params_device
from repro_torch.quant.observers import make_observer
from repro_torch.quant.sidecar import LayerQuant, QuantSidecar


def calibrate(specs: Sequence, params, calib_data, *,
              observer: str = "percentile", device=None) -> QuantSidecar:
    """Build a ``QuantSidecar`` for ``specs``/``params`` from sample inputs.

    ``calib_data`` is one input batch (array or tensor) or a list of them;
    ``observer`` is ``"percentile"`` (default, 99.9th |x|) or ``"minmax"``.
    The replay runs on ``device`` (default: where the params lie).
    """
    from repro_torch.models.resnet import replay_stash

    batches = ([calib_data]
               if isinstance(calib_data, (np.ndarray, torch.Tensor))
               else list(calib_data))
    if not batches:
        raise ValueError("calibrate needs at least one sample batch")
    device = (torch.device(device) if device is not None
              else params_device(params))
    params_t = [tuple(to_tensor(a, device) for a in p) for p in params]

    obs_in = make_observer(observer)
    obs = {i: make_observer(observer) for i, s in enumerate(specs)
           if not isinstance(s, PoolSpec)}
    with torch.no_grad():
        for x in batches:
            stash = replay_stash(specs, params_t, to_tensor(x, device))
            obs_in.observe(stash[-1])
            for i, o in obs.items():
                o.observe(stash[i])
            del stash

    def out_scale(i: int) -> float:
        # POOL is scale passthrough — chase back to the real producer
        while i >= 0 and isinstance(specs[i], PoolSpec):
            i -= 1
        return obs_in.scale if i < 0 else obs[i].scale

    def channel_scales(w) -> tuple[float, ...]:
        # per-output-channel |w|_max over every other axis (the channel
        # axis is last in both HWIO conv and (d_in, d_out) FC weights)
        w = np.asarray(to_numpy(w), np.float32)
        amax = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
        return tuple(float(s) for s in (amax + 1e-12) / 127.0)

    layers, pi = [], 0
    for i, spec in enumerate(specs):
        if isinstance(spec, ConvSpec):
            src = -1 if spec.inp_from == -1 else (
                spec.inp_from if spec.inp_from is not None else i - 1)
            ws = channel_scales(params[pi][0])
            pi += 1
            layers.append(LayerQuant("conv", out_scale(src), obs[i].scale,
                                     wgt_scale=ws))
        elif isinstance(spec, PoolSpec):
            s = out_scale(i - 1)
            layers.append(LayerQuant("pool", s, s, requantize=False))
        elif isinstance(spec, EltwiseSpec):
            layers.append(LayerQuant("eltwise", out_scale(i - 1),
                                     obs[i].scale,
                                     skip_scale=out_scale(spec.skip_from)))
        elif isinstance(spec, DepthwiseSpec):
            # per tensor: the HWIO weight's output axis is a singleton, so a
            # per-channel vector would not broadcast over the grouped conv
            _, ws = quantize_int8(to_numpy(params[pi][0]))
            pi += 1
            layers.append(LayerQuant("dw", out_scale(i - 1), obs[i].scale,
                                     wgt_scale=float(ws)))
        elif isinstance(spec, FCSpec):
            ws = channel_scales(params[pi][0])
            pi += 1
            layers.append(LayerQuant("fc", out_scale(i - 1), obs[i].scale,
                                     wgt_scale=ws))
    return QuantSidecar(input_scale=obs_in.scale, layers=tuple(layers),
                        observer=observer)
