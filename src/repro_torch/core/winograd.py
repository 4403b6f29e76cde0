"""Winograd fast convolution: transforms and the GEMM formulation (Sec. 4.2.1).

An ``F(m x m, r x r)`` Winograd algorithm computes an ``m x m`` output tile
from an ``(m+r-1) x (m+r-1)`` input tile as

    Y = A^T [ (G g G^T) .* (B^T d B) ] A                              (Eq. 1)

and, summed over input channels, the element-wise products split into
``PT^2 = (m+r-1)^2`` *independent GEMMs* (Eq. 2):

    M[p, t, k] = sum_c V[p, t, c] * U[p, c, k]       p in [0, PT^2)

which is a batched matmul with leading batch PT^2.

Supported: F(2x2, 3x3) (PT=4) and F(4x4, 3x3) (PT=6); larger kernels go
through the paper's kernel decomposition (Sec. 4.2.5,
:func:`decompose_kernel`). The transforms here are the ``backend="torch"``
PE (plain tensor ops on any device); the ``backend="hopper"`` PE runs the
same three stages through the CUDA kernels in
``repro_torch.kernels.winograd``.

Layout conventions: feature maps NHWC, kernels HWIO (R, S, C, K).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

R_WINO = 3  # the paper's Winograd algorithms are F(m, 3)


# ---------------------------------------------------------------------------
# Transform matrices (Lavin & Gray, "Fast Algorithms for Convolutional NNs")
# ---------------------------------------------------------------------------

_F2_BT = np.array(
    [[1, 0, -1, 0],
     [0, 1, 1, 0],
     [0, -1, 1, 0],
     [0, 1, 0, -1]], dtype=np.float64)
_F2_G = np.array(
    [[1, 0, 0],
     [0.5, 0.5, 0.5],
     [0.5, -0.5, 0.5],
     [0, 0, 1]], dtype=np.float64)
_F2_AT = np.array(
    [[1, 1, 1, 0],
     [0, 1, -1, -1]], dtype=np.float64)

_F4_BT = np.array(
    [[4, 0, -5, 0, 1, 0],
     [0, -4, -4, 1, 1, 0],
     [0, 4, -4, -1, 1, 0],
     [0, -2, -1, 2, 1, 0],
     [0, 2, -1, -2, 1, 0],
     [0, 4, 0, -5, 0, 1]], dtype=np.float64)
_F4_G = np.array(
    [[1 / 4, 0, 0],
     [-1 / 6, -1 / 6, -1 / 6],
     [-1 / 6, 1 / 6, -1 / 6],
     [1 / 24, 1 / 12, 1 / 6],
     [1 / 24, -1 / 12, 1 / 6],
     [0, 0, 1]], dtype=np.float64)
_F4_AT = np.array(
    [[1, 1, 1, 1, 1, 0],
     [0, 1, -1, 2, -2, 0],
     [0, 1, 1, 4, 4, 0],
     [0, 1, -1, 8, -8, 1]], dtype=np.float64)

_MATRICES = {2: (_F2_BT, _F2_G, _F2_AT), 4: (_F4_BT, _F4_G, _F4_AT)}

# the implemented F(m, 3) transform set — the DSE's eligibility source of
# truth (ConvSpec.wino_eligible)
SUPPORTED_M = tuple(sorted(_MATRICES))


@functools.lru_cache(None)
def transform_matrices(m: int, dtype=np.float32):
    """Return (B^T, G, A^T) for F(m x m, 3 x 3) as numpy arrays."""
    if m not in _MATRICES:
        raise ValueError(f"F({m},{R_WINO}) unsupported; PT must be in {{4, 6}} (m in {{2, 4}})")
    bt, g, at = _MATRICES[m]
    return (np.asarray(bt, dtype), np.asarray(g, dtype), np.asarray(at, dtype))


@functools.lru_cache(None)
def _matrix(m: int, which: int, device: torch.device) -> torch.Tensor:
    """One transform matrix on ``device``, made once per device and never
    evicted: a request copies nothing from the host, and a CUDA graph may
    read it by address for as long as the process lives."""
    return torch.from_numpy(transform_matrices(m)[which]).to(device)


def pt_for(m: int) -> int:
    """Input tile size PT = m + r - 1."""
    return m + R_WINO - 1


def mult_reduction(m: int, r: int = R_WINO) -> float:
    """Multiplication reduction of F(m,r) vs direct conv: (m*r)^2 / (m+r-1)^2.

    Paper example: F(4x4,3x3) needs 36 mults/tile vs 144 direct -> 4.0x.
    """
    return float((m * r) ** 2) / float((m + r - 1) ** 2)


# ---------------------------------------------------------------------------
# Weight transform (offline, Sec. 4.2.3)
# ---------------------------------------------------------------------------

def transform_weights(g_rsck: torch.Tensor, m: int) -> torch.Tensor:
    """U = G g G^T per (c, k): (r, r, C, K) -> (PT, PT, C, K), fp32."""
    r, s, c, k = g_rsck.shape
    if (r, s) != (R_WINO, R_WINO):
        raise ValueError(f"Winograd weights must be 3x3, got {r}x{s}")
    gm = _matrix(m, 1, g_rsck.device)
    return torch.einsum("ir,rsck,js->ijck", gm, g_rsck.float(), gm)


def decompose_kernel(g_rsck: torch.Tensor, m: int
                     ) -> list[tuple[int, int, torch.Tensor]]:
    """Paper Sec. 4.2.5 kernel decomposition for R, S > r.

    Splits an (R, S, C, K) kernel into ceil(R/r) x ceil(S/r) zero-padded
    (r, r, C, K) sub-kernels. Returns a list of ``(offset_h, offset_w,
    subkernel)``, the offsets being the input shift at which the
    sub-kernel's partial conv output accumulates.
    """
    r = R_WINO
    rr, ss = g_rsck.shape[:2]
    nh, nw = -(-rr // r), -(-ss // r)
    gp = F.pad(g_rsck, (0, 0, 0, 0, 0, nw * r - ss, 0, nh * r - rr))
    return [(i * r, j * r, gp[i * r:(i + 1) * r, j * r:(j + 1) * r])
            for i in range(nh) for j in range(nw)]


# ---------------------------------------------------------------------------
# Input tiling / transform and output transform
# ---------------------------------------------------------------------------

def tile_input(x_nhwc: torch.Tensor, m: int
               ) -> tuple[torch.Tensor, tuple[int, int]]:
    """Partition NHWC input into overlapping PT x PT tiles with stride m.

    Input is assumed already padded for the convolution itself (a VALID conv
    of the padded input yields the desired output). Returns ``(tiles,
    (nh, nw))`` with tiles shaped (N, nh, nw, PT, PT, C), contiguous;
    adjacent tiles share an (r-1)-pixel overlap.
    """
    pt = pt_for(m)
    n, h, w, c = x_nhwc.shape
    ho, wo = h - R_WINO + 1, w - R_WINO + 1  # VALID conv output size
    nh, nw = -(-ho // m), -(-wo // m)
    # pad so the tile grid covers the full output
    hp, wp = (nh - 1) * m + pt, (nw - 1) * m + pt
    x = F.pad(x_nhwc, (0, 0, 0, wp - w, 0, hp - h))
    # (N, nh, Wp, C, PT) -> (N, nh, nw, C, PT, PT) -> (N, nh, nw, PT, PT, C)
    tiles = x.unfold(1, pt, m).unfold(2, pt, m).permute(0, 1, 2, 4, 5, 3)
    return tiles.contiguous(), (nh, nw)


def transform_input(tiles: torch.Tensor, m: int) -> torch.Tensor:
    """V = B^T d B: (N, nh, nw, PT, PT, C) -> (PT*PT, N*nh*nw, C)."""
    bt = _matrix(m, 0, tiles.device)
    pt, c = tiles.shape[-2], tiles.shape[-1]
    d = tiles.reshape(-1, pt, pt, c).float()
    v = torch.einsum("ip,xpqc,jq->ijxc", bt, d, bt)
    return v.reshape(pt * pt, -1, c)


def transform_output(m_ptsq: torch.Tensor, m: int, n: int, nh: int,
                     nw: int) -> torch.Tensor:
    """Y = A^T M A: (PT*PT, N*nh*nw, K) -> (N, nh*m, nw*m, K)."""
    at = _matrix(m, 2, m_ptsq.device)
    _, t, k = m_ptsq.shape
    pt = pt_for(m)
    mm = m_ptsq.reshape(pt, pt, t, k).float()
    y = torch.einsum("ip,pqxk,jq->xijk", at, mm, at)     # (t, m, m, K)
    y = y.reshape(n, nh, nw, m, m, k).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, nh * m, nw * m, k)


def pad_for_conv(x_nhwc: torch.Tensor, padding: str) -> torch.Tensor:
    """SAME/VALID input padding for a VALID 3x3 conv of the result."""
    if padding.upper() == "SAME":
        ph = (R_WINO - 1) // 2
        pl = R_WINO - 1 - ph
        return F.pad(x_nhwc, (0, 0, ph, pl, ph, pl))
    if padding.upper() == "VALID":
        return x_nhwc
    raise ValueError(padding)


def winograd_apply_pretransformed(
    x_nhwc: torch.Tensor,
    u_ptck: torch.Tensor,       # (PT, PT, C, K) offline-transformed weights
    bias: torch.Tensor | None,
    m: int,
    relu: bool = False,
    padding: str = "SAME",
) -> torch.Tensor:
    """Winograd conv with weights already in U-space (r = 3, stride 1).

    The ``backend="torch"`` COMP path: the paper stores *transformed*
    weights in DRAM (Sec. 4.2.3), so the PE consumes U directly.
    """
    pt, _, c, k = u_ptck.shape
    if pt != pt_for(m):
        raise ValueError(f"U tile {pt} does not match m={m}")
    x = pad_for_conv(x_nhwc, padding)
    n = x.shape[0]
    ho, wo = x.shape[1] - R_WINO + 1, x.shape[2] - R_WINO + 1
    tiles, (nh, nw) = tile_input(x, m)
    v = transform_input(tiles, m)                              # (PT^2, T, C)
    u = u_ptck.float().reshape(pt * pt, c, k)
    mm = torch.bmm(v, u)                                       # the PT^2 GEMMs
    y = transform_output(mm, m, n, nh, nw)[:, :ho, :wo, :]
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y


def winograd_conv2d_reference(x_nhwc: torch.Tensor, g_rsck: torch.Tensor,
                              m: int = 4, padding="SAME") -> torch.Tensor:
    """End-to-end Winograd convolution (stride 1), fp32, plain tensor ops:
    the oracle and the ``backend="torch"`` path of ``hybrid_conv2d``.

    Handles R, S != 3 through the kernel decomposition: the input is padded
    once (``padding`` is "SAME", "VALID" or ``((top, bottom), (left,
    right))``), then extended so every shifted sub-kernel sees a full
    window, and the pieces' outputs are summed.
    """
    rr, ss, c, k = g_rsck.shape
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            ph, pw = (rr - 1) // 2, (ss - 1) // 2
            pad = ((ph, rr - 1 - ph), (pw, ss - 1 - pw))
        elif padding.upper() == "VALID":
            pad = ((0, 0), (0, 0))
        else:
            raise ValueError(padding)
    else:
        pad = padding
    (top, bottom), (left, right) = pad
    x = F.pad(x_nhwc.float(), (0, 0, left, right, top, bottom))
    n = x.shape[0]
    ho, wo = x.shape[1] - rr + 1, x.shape[2] - ss + 1

    if (rr, ss) == (R_WINO, R_WINO):
        pieces = [(0, 0, g_rsck)]
    else:
        pieces = decompose_kernel(g_rsck, m)
        # pad the input so every shifted sub-conv sees a full window
        extra_h = (-(-rr // R_WINO)) * R_WINO - rr
        extra_w = (-(-ss // R_WINO)) * R_WINO - ss
        x = F.pad(x, (0, 0, 0, extra_w, 0, extra_h))

    pt = pt_for(m)
    acc = None
    for oh, ow, sub in pieces:
        xs = x[:, oh:oh + ho + R_WINO - 1, ow:ow + wo + R_WINO - 1, :]
        tiles, (nh, nw) = tile_input(xs, m)
        v = transform_input(tiles, m)                          # (PT^2, T, C)
        u = transform_weights(sub, m).reshape(pt * pt, c, k)
        mm = torch.bmm(v, u)                                   # the PT^2 GEMMs
        y = transform_output(mm, m, n, nh, nw)[:, :ho, :wo, :]
        acc = y if acc is None else acc + y
    return acc
