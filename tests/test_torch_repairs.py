"""Guards for repaired port faults, each held against the reference package
on the same inputs:

* the program cache's validation table is LRU-bounded at
  ``validated_maxsize`` (default ``4 * maxsize``), never drops a schedule
  with live entries, and counts ``validated_evictions`` exactly as the
  reference's does (``tests/test_opt_lowering.py``'s sequence, run on both
  packages);
* the serving CLI requires ``--arch`` and defaults ``--batch`` to 4, as the
  reference's does (both ``main()``s driven with their serve functions
  replaced by recorders), and takes ``--mesh none|host`` with the
  reference's default;
* F3: an entry's CUDA graphs follow the live weight sets, so five weight
  sets taking turns on one stream capture once each (the graph table's
  policy, with stub graphs; the card's guard is in
  ``tests/test_torch_gpu.py``).
"""
import dataclasses
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compiler as r_compiler  # noqa: E402
from repro.core.hybrid_conv import ConvSpec as RConvSpec  # noqa: E402
from repro.core.program_cache import ProgramCache as RProgramCache  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec as TConvSpec  # noqa: E402
from repro_torch.core.program_cache import (  # noqa: E402
    ProgramCache as TProgramCache,
)
from repro_torch.launch import serve as t_serve  # noqa: E402


def _programs(n: int):
    """``n`` distinct one-layer schedules (output widths 4, 5, ...), the
    same specs and plans compiled by each package."""
    out = {"ref": [], "port": []}
    for k in range(4, 4 + n):
        for pkg, compiler, spec in (("ref", r_compiler, RConvSpec),
                                    ("port", t_compiler, TConvSpec)):
            specs = [spec("c1", 12, 12, 3, k, padding="SAME", relu=True)]
            out[pkg].append(compiler.compile_network(
                specs, [compiler.LayerPlan("spat", "is", 2, 1, 1)]))
    return out


def _cache_state(cache) -> tuple:
    s = cache.stats
    return (len(cache), cache.validated_size, s.evictions,
            s.validated_evictions, s.hits, s.misses)


def test_validated_table_bounded_like_reference():
    """The reference's sequence (``tests/test_opt_lowering.py``,
    ``test_validated_table_bounded_with_eviction_stats``): 8 distinct
    programs through ``get`` on ``ProgramCache(maxsize=2,
    validated_maxsize=3)``, then a re-validate of the newest (a live
    schedule: a hit, nothing evicted)."""
    progs = _programs(8)
    ref = RProgramCache(maxsize=2, validated_maxsize=3)
    port = TProgramCache(maxsize=2, validated_maxsize=3)
    for rp, tp in zip(progs["ref"], progs["port"]):
        ref.get(rp, batch=1, dtype=jnp.float32)
        port.get(tp, batch=1, dtype=torch.float32, device="cpu")
        assert _cache_state(port) == _cache_state(ref)
    assert len(port) == 2 and port.validated_size <= 3
    assert port.stats.validated_evictions >= len(progs["port"]) - 3
    before = (ref.stats.validated_evictions, port.stats.validated_evictions)
    ref.validate(progs["ref"][-1])
    port.validate(progs["port"][-1])
    assert (ref.stats.validated_evictions,
            port.stats.validated_evictions) == before
    assert _cache_state(port) == _cache_state(ref)


@pytest.mark.parametrize("maxsize,validated_maxsize,n", [
    (2, 3, 8),        # the reference's validate-only test
    (2, None, 40),    # the default bound, 4 * maxsize: 40 programs keep 8
])
def test_validate_only_callers_bounded_like_reference(maxsize,
                                                      validated_maxsize, n):
    progs = _programs(n)
    ref = RProgramCache(maxsize=maxsize, validated_maxsize=validated_maxsize)
    port = TProgramCache(maxsize=maxsize, validated_maxsize=validated_maxsize)
    assert port.validated_maxsize == ref.validated_maxsize
    for rp, tp in zip(progs["ref"], progs["port"]):
        assert port.validate(tp) == ref.validate(rp)
        assert _cache_state(port) == _cache_state(ref)
    assert port.validated_size == min(n, port.validated_maxsize)
    assert port.stats.validated_evictions == n - port.validated_size


def test_live_schedules_keep_their_validation():
    """Validate-only traffic never evicts a schedule that still has a live
    entry, in either package: re-validating it stays a table hit."""
    progs = _programs(10)
    caches = {"ref": RProgramCache(maxsize=2, validated_maxsize=2),
              "port": TProgramCache(maxsize=2, validated_maxsize=2)}
    caches["ref"].get(progs["ref"][0], batch=1, dtype=jnp.float32)
    caches["port"].get(progs["port"][0], batch=1, dtype=torch.float32,
                       device="cpu")
    for pkg, cache in caches.items():
        for p in progs[pkg][1:]:
            cache.validate(p)
        live = progs[pkg][0].schedule_key()
        assert live in cache._validated
        before = cache.stats.validated_evictions
        cache.validate(progs[pkg][0])
        assert cache.stats.validated_evictions == before
    assert _cache_state(caches["port"]) == _cache_state(caches["ref"])


class _Recorder:
    """Stands in for a serve function: records its call, returns a result
    each ``main()`` can print."""

    def __init__(self):
        self.calls = []

    def __call__(self, arch, **kw):
        self.calls.append(dict(kw, arch=arch))
        return types.SimpleNamespace(shape=(1, 1), tokens=np.zeros((1, 1)))


def _drive(monkeypatch, module, argv):
    """Run ``module.main()`` on ``argv`` with ``serve``/``serve_cnn``
    replaced by recorders; return the (cnn, lm) recorders."""
    cnn, lm = _Recorder(), _Recorder()
    monkeypatch.setattr(module, "serve_cnn", cnn)
    monkeypatch.setattr(module, "serve", lm)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    module.main()
    return cnn, lm


@pytest.mark.parametrize("arch,kind", [("vgg16", "cnn"), ("resnet18", "cnn"),
                                       ("minitron-8b", "lm")])
def test_serve_cli_batch_defaults_to_4_like_reference(monkeypatch, capsys,
                                                      arch, kind):
    for module in (r_serve, t_serve):
        cnn, lm = _drive(monkeypatch, module, ["--arch", arch])
        rec = cnn if kind == "cnn" else lm
        assert len(rec.calls) == 1 and len((lm if kind == "cnn"
                                            else cnn).calls) == 0
        assert rec.calls[0]["arch"] == arch
        assert rec.calls[0]["batch"] == 4, module.__name__
    capsys.readouterr()


def test_serve_cli_requires_arch_like_reference(monkeypatch, capsys):
    for module in (r_serve, t_serve):
        with pytest.raises(SystemExit) as exc:
            _drive(monkeypatch, module, [])
        assert exc.value.code == 2, module.__name__
        assert "--arch" in capsys.readouterr().err


@pytest.mark.parametrize("argv,mesh", [([], "host"), (["--mesh", "none"],
                                                      "none"),
                                       (["--mesh", "host"], "host")])
def test_serve_cli_mesh_like_reference(monkeypatch, capsys, argv, mesh):
    for module in (r_serve, t_serve):
        cnn, _ = _drive(monkeypatch, module,
                        ["--arch", "vgg16", "--session", *argv])
        assert cnn.calls[0]["mesh"] == mesh, module.__name__
        assert cnn.calls[0]["session"] is True
    capsys.readouterr()


def _stub_graph(weights):
    import threading
    import weakref
    from repro_torch.core import executor
    return executor._Graph(None, None, None,
                           tuple(weakref.ref(t) for t in weights), [], {},
                           threading.Lock())


def test_graph_table_keeps_every_live_weight_set():
    """F3: five weight sets of one entry called in rotation on one stream
    for three rounds miss only in the first round (one capture per weight
    set, where a fixed bound of four graphs missed every call); a weight
    set that dies takes its graph with it, and the others keep theirs."""
    import gc
    from repro_torch.core import executor
    table = executor._GraphTable(executor.STREAMS_PER_WEIGHTS)
    weights = [torch.zeros(2) for _ in range(5)]
    stream, misses = 7, []
    for rnd in range(3):
        for i, w in enumerate(weights):
            key = (stream, (w.data_ptr(),))
            if table.get(key) is None:
                misses.append((rnd, i))
                table.put(key, _stub_graph([w]))
    assert misses == [(0, i) for i in range(5)]
    assert len(table) == 5
    dead_key = (stream, (weights[2].data_ptr(),))
    del weights[2]
    gc.collect()
    assert table.get(dead_key) is None and len(table) == 4
    for w in weights:
        assert table.get((stream, (w.data_ptr(),))) is not None
    # one weight set over more streams than the bound keeps its most recent
    w = weights[0]
    for s in range(8, 8 + executor.STREAMS_PER_WEIGHTS):
        table.put((s, (w.data_ptr(),)), _stub_graph([w]))
    assert table.get((stream, (w.data_ptr(),))) is None
    assert len(table) == 3 + executor.STREAMS_PER_WEIGHTS
