"""Feature-map data layouts and the SAVE-side reorder transforms (Sec. 4.3).

The paper defines two external-memory layouts (Figure 5):

* ``SPAT`` — plain raster order. Here: NHWC.
* ``WINO`` — tile-position-major order so that the Winograd load manager can
  stream all tiles of one (tile-row, tile-col) position contiguously.
  Here: (N, nh, nw, m, m, C) — output tiles of size m x m laid out tile-major.

The SAVE module supports all four layout transforms (WINO-to-WINO,
WINO-to-SPAT, SPAT-to-SPAT, SPAT-to-WINO) so successive layers may run in
different CONV modes without a standalone reorder pass; the LOAD module only
ever performs identity loads. Here the transforms are tensor views plus one
copy where the layout really changes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SPAT = "spat"
WINO = "wino"


def _check_divisible(h: int, w: int, m: int):
    if h % m or w % m:
        raise ValueError(f"feature map {h}x{w} not divisible by tile size m={m}; "
                         "pad before converting to WINO layout")


def spat_to_wino(x_nhwc: torch.Tensor, m: int) -> torch.Tensor:
    """NHWC -> (N, H/m, W/m, m, m, C) tile-major WINO layout."""
    n, h, w, c = x_nhwc.shape
    _check_divisible(h, w, m)
    x = x_nhwc.reshape(n, h // m, m, w // m, m, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous()


def wino_to_spat(x_tiled: torch.Tensor) -> torch.Tensor:
    """(N, nh, nw, m, m, C) -> NHWC."""
    n, nh, nw, m, m2, c = x_tiled.shape
    if m != m2:
        raise ValueError(f"WINO tiles must be square, got {m}x{m2}")
    x = x_tiled.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, nh * m, nw * m, c)


def save_transform(y_nhwc: torch.Tensor, to_layout: str, m: int) -> torch.Tensor:
    """SAVE-side reorder: COMP always emits NHWC internally; SAVE writes the
    layout the *next* layer's mode wants (the paper's 4 transform modes)."""
    if to_layout == SPAT:
        return y_nhwc
    if to_layout == WINO:
        n, h, w, c = y_nhwc.shape
        ph, pw = (-h) % m, (-w) % m
        if ph or pw:
            y_nhwc = F.pad(y_nhwc, (0, 0, 0, pw, 0, ph))
        return spat_to_wino(y_nhwc, m)
    raise ValueError(to_layout)


def load_view(x: torch.Tensor, layout: str,
              hw: tuple[int, int] | None = None) -> torch.Tensor:
    """LOAD-side identity view back to NHWC for COMP.

    ``hw`` crops padding introduced by save_transform for non-divisible maps.
    """
    if layout == SPAT:
        return x
    if layout == WINO:
        y = wino_to_spat(x)
        if hw is not None:
            y = y[:, :hw[0], :hw[1], :]
        return y
    raise ValueError(layout)


def layout_for_mode(mode: str) -> str:
    """The layout a layer's LOAD manager wants given its CONV mode."""
    return WINO if mode == "wino" else SPAT
