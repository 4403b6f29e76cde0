"""K3 ``wino_input_transform_f32`` and K4 ``wino_output_transform_f32``.

Replace ``src/repro/kernels/winograd/kernel.py::input_transform_kernel``
(tiles ``(T, PT, PT, C)`` -> ``V = B^T d B`` laid out ``(PT^2, T, C)``) and
``::output_transform_kernel`` (``M (PT^2, T, K)`` -> ``Y = A^T M A`` laid out
``(T, m, m, K)``, with the bias add and ReLU fused). The CUDA kernels live
in ``csrc/winograd_f32.cu``; their note says what bounds them and what the
design does about that.
"""
from __future__ import annotations

import torch

from repro_torch.core.winograd import SUPPORTED_M, pt_for, transform_matrices
from repro_torch.kernels.common import launch, on_cpu


def _check_m(m: int):
    if m not in SUPPORTED_M:
        raise ValueError(f"Winograd m must be one of {SUPPORTED_M}, got {m}")


def wino_input_transform_ref(tiles: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`wino_input_transform_f32`."""
    bt = torch.from_numpy(transform_matrices(m)[0]).to(tiles.device)
    t, pt, _, c = tiles.shape
    v = torch.einsum("ip,tpqc,jq->ijtc", bt, tiles, bt)
    return v.reshape(pt * pt, t, c)


def wino_input_transform_f32(tiles: torch.Tensor, m: int) -> torch.Tensor:
    """(T, PT, PT, C) -> V (PT^2, T, C), PT = m + 2, fp32."""
    _check_m(m)
    pt = pt_for(m)
    if tiles.dim() != 4 or tiles.shape[1:3] != (pt, pt):
        raise ValueError(f"tiles must be (T, {pt}, {pt}, C), got {tiles.shape}")
    if on_cpu("wino_input_transform_f32", tiles):
        return wino_input_transform_ref(tiles, m)
    t, _, _, c = tiles.shape
    out = torch.empty((pt * pt, t, c), dtype=torch.float32,
                      device=tiles.device)
    if out.numel():
        launch("wino_input_transform_f32", [tiles, out], [t, c, m])
    return out


def wino_output_transform_ref(m_arr: torch.Tensor,
                              bias: torch.Tensor | None, m: int,
                              relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`wino_output_transform_f32`."""
    at = torch.from_numpy(transform_matrices(m)[2]).to(m_arr.device)
    pt = pt_for(m)
    _, t, k = m_arr.shape
    y = torch.einsum("ip,pqtk,jq->tijk", at, m_arr.reshape(pt, pt, t, k), at)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def wino_output_transform_f32(m_arr: torch.Tensor,
                              bias: torch.Tensor | None, m: int,
                              relu: bool = False) -> torch.Tensor:
    """M (PT^2, T, K) [+ bias (K,)] [ReLU] -> Y (T, m, m, K), fp32."""
    _check_m(m)
    pt = pt_for(m)
    if m_arr.dim() != 3 or m_arr.shape[0] != pt * pt:
        raise ValueError(f"M must be ({pt * pt}, T, K), got {m_arr.shape}")
    _, t, k = m_arr.shape
    if bias is not None and bias.shape != (k,):
        raise ValueError(f"bias must be {(k,)}, got {bias.shape}")
    if on_cpu("wino_output_transform_f32", m_arr, bias):
        return wino_output_transform_ref(m_arr, bias, m, relu)
    out = torch.empty((t, m, m, k), dtype=torch.float32, device=m_arr.device)
    if out.numel():
        launch("wino_output_transform_f32", [m_arr, bias, out],
               [t, k, m, relu])
    return out
