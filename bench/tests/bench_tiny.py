"""Tiny configurations of the benchmark's networks, for the CPU tests."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def table(specs) -> list[dict]:
    """A layer table from ``repro_torch``'s spec chain (tiny tables for
    the CPU)."""
    from repro_torch.core.hybrid_conv import ConvSpec, PoolSpec
    out = []
    for s in specs:
        if isinstance(s, ConvSpec):
            d = dict(kind="conv", name=s.name, h=s.h, w=s.w, c=s.c, k=s.k,
                     r=s.r, s=s.s, stride=s.stride, padding=s.padding,
                     relu=s.relu)
        elif isinstance(s, PoolSpec):
            d = dict(kind="pool", name=s.name, h=s.h, w=s.w, c=s.c,
                     window=s.window, stride=s.stride)
        else:
            d = dict(kind="fc", name=s.name, d_in=s.d_in, d_out=s.d_out,
                     relu=s.relu)
        out.append(d)
    return out


def tiny_config(name: str) -> dict:
    """A configuration of ``bench/configs`` cut to a width and resolution
    the CPU runs in a second, with its own limit kept."""
    from repro_torch.models import vgg
    config = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                        .read_text())
    config.update(input_resolution=32,
                  layers=table(vgg.network_specs(32, 16, n_classes=10)))
    return config
