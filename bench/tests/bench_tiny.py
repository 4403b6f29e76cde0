"""Tiny configurations of the benchmark's networks, for the CPU tests."""
import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def kinds() -> dict:
    """The port's spec class of every kind in ``bench/layers`` -> the
    kind's name."""
    from bench.layers import find
    return {find(p.stem).spec(): p.stem
            for p in (ROOT / "bench" / "layers").glob("*.py")
            if p.stem != "__init__"}


def _table_value(v):
    return list(map(_table_value, v)) if isinstance(v, tuple) else v


def table(specs) -> list[dict]:
    """A layer table from ``repro_torch``'s spec chain: every field of each
    spec under its own name, ``inp_from`` as a ``from`` and ``skip_from``
    as a ``skip`` that name the layer (``"input"`` for -1)."""
    kind_of = kinds()

    def name(i):
        return "input" if i == -1 else specs[i].name
    out = []
    for s in specs:
        d = {"kind": kind_of[type(s)]}
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            if f.name == "inp_from":
                if v is not None:
                    d["from"] = name(v)
            elif f.name == "skip_from":
                d["skip"] = name(v)
            else:
                d[f.name] = _table_value(v)
        out.append(d)
    return out


def tiny_resnet18() -> list:
    """The port's ResNet-18 at a 32x32 input and a sixteenth of its
    widths: adds, 1x1/2 projections and inputs rerouted."""
    from repro_torch.models import resnet
    return resnet.resnet18_specs(32, 16, n_classes=10)


def tiny_dw_chain() -> list:
    """A conv and two depthwise convs, the second strided, as the port's
    depthwise chain."""
    from repro_torch.core.hybrid_conv import (ConvSpec, DepthwiseSpec,
                                              FCSpec, PoolSpec)
    return [ConvSpec("c1", 32, 32, 3, 8), DepthwiseSpec("d1", 32, 32, 8),
            DepthwiseSpec("d2", 32, 32, 8, stride=2),
            PoolSpec("p1", 16, 16, 8), FCSpec("f1", 8 * 8 * 8, 10)]


def tiny_config(name: str, specs=None) -> dict:
    """A configuration of ``bench/configs`` cut to a width and resolution
    the CPU runs in a second, with its own limit kept; ``specs``, a spec
    chain at a 32x32 input, in place of its own network."""
    from repro_torch.models import vgg
    config = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                        .read_text())
    config.update(input_resolution=32, layers=table(
        specs or vgg.network_specs(32, 16, n_classes=10)))
    return config
