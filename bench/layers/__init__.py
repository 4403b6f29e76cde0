"""Layer kinds of the benchmark's layer tables, each found by its name.

An entry of a configuration's ``layers`` names its ``kind``, and a kind is
two files of that name: ``bench/layers/<kind>.py`` for the harness and the
yardstick, with ``spec()`` (the port's spec class, imported when called),
``out_hw(layer)``, ``flops(layer, batch)`` and ``bytes(layer, batch)``; and
``bench/reference/<kind>.py``, the plain reference, with
``weight_shape(layer)`` and ``forward(layer, x, params, skip, cast)``. A new
kind is those two files and no edit elsewhere.

Wiring: any entry may name ``from``, an earlier entry's ``name`` or
``"input"`` for the image, where it reads another map than the one before
it; an ``add`` names its second operand ``skip``."""
from __future__ import annotations

import importlib

INPUT = "input"


def find(kind: str, part: str = "layers"):
    """The module of ``kind`` in ``bench.<part>`` (``layers`` or
    ``reference``)."""
    name = f"bench.{part}.{kind}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"unknown layer kind {kind!r}: no "
                         f"bench/{part}/{kind}.py") from None
