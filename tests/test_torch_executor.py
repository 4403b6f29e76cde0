"""The port's executor, runtime and API against the reference: schedule
validation and hazards, optimizer verdicts, and reduced-VGG16 logits from
both port backends at both opt levels against the reference's ``xla`` and
``pallas`` (interpret-mode) executors. Tolerance ``rtol=atol=1e-4``, the
reference's own fp32 budget (``tests/test_backend_pallas.py``)."""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from conftest import flip_first_comp  # noqa: E402
from test_hazards import (  # noqa: E402
    HAZARDS,
    POOL_FC_HAZARDS,
    RESIDUAL_HAZARDS,
    _full_net,
    _mutate,
    _mutate_full,
    _mutate_residual,
    _net,
    _residual_net,
)

from repro import api as r_api  # noqa: E402
from repro.core import compiler as r_compiler  # noqa: E402
from repro.core import executor as r_executor  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.core.hybrid_conv import ConvSpec as RConvSpec  # noqa: E402
from repro.models import vgg as r_vgg  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core import executor as t_executor  # noqa: E402
from repro_torch.core import hybrid_conv as t_hc  # noqa: E402
from repro_torch.core import perf_model as t_pm  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    CompiledExecutor,
    compile_executor,
    height_pad,
    width_pad,
)
from repro_torch.core.program_cache import ProgramCache, cache_key  # noqa: E402
from repro_torch.core.runtime import HybridRuntime  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.spatial_conv import ops as conv_ops  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BACKEND_PAIRS = [("torch", "xla"), ("hopper", "pallas")]


def _mixed_plans():
    """The reduced-VGG plan set of tests/test_backend_pallas.py: Winograd
    (m=2) on even CONVs, IS/WS alternating, 2x2 row/k groups on the first
    two CONVs."""
    plans, ci = [], 0
    for s in r_vgg.network_specs(img=32, scale=32, n_classes=10):
        if isinstance(s, RConvSpec):
            g = 2 if ci < 2 else 1
            plans.append(("wino" if ci % 2 == 0 else "spat",
                          "is" if ci % 2 else "ws", 2, g, g))
            ci += 1
        else:
            plans.append(None)
    return plans


def _programs(plans):
    r_specs = r_vgg.network_specs(img=32, scale=32, n_classes=10)
    t_specs = t_vgg.network_specs(img=32, scale=32, n_classes=10)
    r_prog = r_compiler.compile_network(
        r_specs, [p and r_compiler.LayerPlan(*p) for p in plans])
    t_prog = t_compiler.compile_network(
        t_specs, [p and t_compiler.LayerPlan(*p) for p in plans])
    return r_specs, t_specs, r_prog, t_prog


def _to_port(r_prog):
    """A reference Program's instructions/layers re-wrapped for the port's
    validator (IntEnum opcodes compare by value)."""
    return t_compiler.Program(list(r_prog.instructions), list(r_prog.layers),
                              r_prog.dram_size_words)


# ---------------------------------------------------------------------------
# Phase 1: schedule validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["reduced-mixed", "full-dse"])
def test_validate_schedule_stats_match(net):
    if net == "reduced-mixed":
        _, _, r_prog, t_prog = _programs(_mixed_plans())
    else:
        r_specs = r_vgg.network_specs(224, 1, n_classes=1000)
        t_specs = t_vgg.network_specs(224, 1, n_classes=1000)
        r_prog = r_compiler.compile_network(
            r_specs, r_pm.V5E.run_dse(r_specs, batch=8).plans)
        t_prog = t_compiler.compile_network(
            t_specs, t_pm.V5E.run_dse(t_specs, batch=8).plans)
    assert t_executor.validate_schedule(t_prog) == \
        r_executor.validate_schedule(r_prog)


# test_hazards' three nets and their mutators: two CONVs with 4 row groups
# (ping-pong slots reused); CONV -> POOL -> CONV -> FC; CONV -> CONV ->
# ELTWISE(skip = conv0) -> DEPTHWISE
HAZARD_NETS = {"conv": (_net, _mutate), "full": (_full_net, _mutate_full),
               "residual": (_residual_net, _mutate_residual)}
HAZARD_CASES = ([("conv", h) for h in HAZARDS]
                + [("full", h) for h in POOL_FC_HAZARDS]
                + [("residual", h) for h in RESIDUAL_HAZARDS])


@functools.lru_cache(maxsize=None)
def _port_net(kind: str):
    """One of test_hazards' nets compiled by the port, with the
    reference's params and input (drawn from ``jax.random``) carried
    across as numpy arrays."""
    specs, plans, params, x = HAZARD_NETS[kind][0]()
    t_specs = [getattr(t_hc, type(s).__name__)(**dataclasses.asdict(s))
               for s in specs]
    prog = t_compiler.compile_network(
        t_specs, [p and t_compiler.LayerPlan(*dataclasses.astuple(p))
                  for p in plans])
    return (t_specs, prog, [(np.asarray(w), np.asarray(b)) for w, b in params],
            np.asarray(x))


@pytest.mark.parametrize("kind,hazard", HAZARD_CASES,
                         ids=[h for _, h in HAZARD_CASES])
def test_port_validation_raises_on_reference_hazards(kind, hazard):
    """Every one of the reference's 25 mutated streams raises
    ``HazardError`` in the port's validation pass, in its executor before
    any compute, and in its strict interpreter."""
    specs, prog, params, x = _port_net(kind)
    bad = _to_port(HAZARD_NETS[kind][1](prog, hazard))
    with pytest.raises(t_executor.HazardError):
        t_executor.validate_schedule(bad)
    # the runtime refuses the stream before any compute: nothing lowered
    cache = ProgramCache()
    rt = HybridRuntime(bad, device="cpu", cache=cache)
    rt.load_params(params)
    with pytest.raises(t_executor.HazardError):
        rt.run(x)
    assert len(cache) == 0
    st = HybridRuntime(bad, strict=True, device="cpu")
    st.load_params(params)
    with pytest.raises(t_executor.HazardError):
        st.run(x)


@pytest.mark.parametrize("kind", list(HAZARD_NETS))
def test_port_good_streams_pass_all_three_paths(kind):
    """tests/test_hazards.py:99, :206, :327 on the port: the unmutated
    streams pass validation, the executor and the interpreter, with the
    reference's stats on all three."""
    specs, prog, params, x = _port_net(kind)
    stats = t_executor.validate_schedule(prog)
    r_specs, r_plans, _, _ = HAZARD_NETS[kind][0]()
    assert stats == r_executor.validate_schedule(
        r_compiler.compile_network(r_specs, r_plans))
    rt = HybridRuntime(prog, opt_level=0, device="cpu", cache=ProgramCache())
    rt.load_params(params)
    y = rt.run(x)
    assert rt.stats == stats
    st = HybridRuntime(prog, strict=True, device="cpu")
    st.load_params(params)
    assert torch.equal(st.run(x), y)
    assert st.stats == stats


# ---------------------------------------------------------------------------
# The lowering optimizer's verdicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("pair", BACKEND_PAIRS, ids=lambda p: p[0])
def test_analyze_program_verdicts_match(pair, flip):
    t_backend, r_backend = pair
    _, _, r_prog, t_prog = _programs(_mixed_plans())
    if flip:    # one COMP's RELU bit inverted: a mixed-RELU layer
        r_prog = flip_first_comp(r_prog, 0)
        t_prog = flip_first_comp(t_prog, 0)
    r_v = r_executor.analyze_program(r_prog, backend=r_backend)
    t_v = t_executor.analyze_program(t_prog, backend=t_backend)
    assert {k: (v.kind, v.relu, v.relu_blocks) for k, v in t_v.items()} == \
        {k: (v.kind, v.relu, v.relu_blocks) for k, v in r_v.items()}
    if flip:
        assert t_v[0].kind == ("block" if t_backend == "hopper"
                               else "stacked")


# ---------------------------------------------------------------------------
# End to end: reduced-VGG16 logits against both reference executors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_logits():
    """The reference's xla and pallas (interpret) logits, computed once."""
    plans = _mixed_plans()
    r_specs, t_specs, _, _ = _programs(plans)
    r_params = r_api.random_params(r_specs, seed=0)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    r_plans = [p and r_compiler.LayerPlan(*p) for p in plans]
    out = {}
    for backend in ("xla", "pallas"):
        acc = r_api.Accelerator.build(r_specs, plans=r_plans, params=r_params,
                                      batch=2, backend=backend)
        out[backend] = np.asarray(acc(jnp.asarray(x)))
    params_np = [(np.asarray(w), np.asarray(b)) for w, b in r_params]
    return t_specs, plans, params_np, x, out


@pytest.mark.parametrize("opt_level", [0, 1])
@pytest.mark.parametrize("pair", BACKEND_PAIRS, ids=lambda p: p[0])
def test_reduced_vgg16_logits_match_reference(reference_logits, pair,
                                              opt_level):
    t_specs, plans, params_np, x, ref = reference_logits
    t_backend, r_backend = pair
    common.reset_launches()
    acc = t_api.Accelerator.build(
        t_specs, plans=[p and t_compiler.LayerPlan(*p) for p in plans],
        params=t_api.params_from_numpy(params_np, "cpu"), batch=2,
        backend=t_backend, opt_level=opt_level, device="cpu",
        cache=ProgramCache())
    y = acc(x).numpy()
    assert y.shape == (2, 10) and np.isfinite(y).all()
    # the matching reference backend, and the other one too
    np.testing.assert_allclose(y, ref[r_backend], **TOL)
    np.testing.assert_allclose(y, ref["xla" if r_backend == "pallas"
                                      else "pallas"], **TOL)
    # relative agreement, well inside the absolute budget on these logits
    scale = np.abs(ref["xla"]).max()
    assert np.abs(y - ref["xla"]).max() <= 1e-4 * scale
    # the hopper backend on CPU tensors runs the plain versions only
    assert common.LAUNCHES == dict.fromkeys(common.KERNELS, 0)


def guard_hopper_winograd_copies(monkeypatch) -> dict:
    """While a ``hopper`` Winograd block runs (``conv_block_forward`` on a
    ``wino`` plan), make ``F.pad``, ``tile_input`` and ``pad_for_conv``
    raise, except inside the kernels' plain versions: on the CPU they stand
    in for K3 and K4, which read and write the NHWC images themselves.
    Returns the count of Winograd blocks watched (``"blocks"``)."""
    from repro_torch.core import winograd as t_wino
    from repro_torch.kernels.winograd import kernel as t_wk

    state = {"pe": 0, "plain": 0, "blocks": 0}

    def forbidden(name, fn):
        def call(*a, **kw):
            if state["pe"] and not state["plain"]:
                raise AssertionError(f"{name} on the hopper Winograd path")
            return fn(*a, **kw)
        return call

    def plain(fn):
        def call(*a, **kw):
            state["plain"] += 1
            try:
                return fn(*a, **kw)
            finally:
                state["plain"] -= 1
        return call

    block_forward = t_executor.conv_block_forward

    def watched_block(cl, *a, **kw):
        watched = cl.plan.mode == "wino" and kw.get("backend") == "hopper"
        state["pe"] += watched
        state["blocks"] += watched
        try:
            return block_forward(cl, *a, **kw)
        finally:
            state["pe"] -= watched

    monkeypatch.setattr(t_executor, "conv_block_forward", watched_block)
    monkeypatch.setattr(torch.nn.functional, "pad",
                        forbidden("F.pad", torch.nn.functional.pad))
    for mod in (t_wino, t_wk):
        monkeypatch.setattr(mod, "tile_input",
                            forbidden("tile_input", t_wino.tile_input))
    monkeypatch.setattr(t_wino, "pad_for_conv",
                        forbidden("pad_for_conv", t_wino.pad_for_conv))
    for name in ("wino_input_transform_nhwc_ref", "wino_input_transform_ref",
                 "wino_output_transform_nhwc_ref",
                 "wino_output_transform_ref"):
        monkeypatch.setattr(t_wk, name, plain(getattr(t_wk, name)))
    return state


@pytest.mark.parametrize("opt_level", [0, 1])
def test_reduced_vgg16_hopper_winograd_copies_nothing(reference_logits,
                                                      monkeypatch, opt_level):
    """Between the input slab and K3, and after K4, nothing on the hopper
    Winograd path pads, gathers or copies the activation; the logits still
    match the reference's."""
    t_specs, plans, params_np, x, ref = reference_logits
    state = guard_hopper_winograd_copies(monkeypatch)
    acc = t_api.Accelerator.build(
        t_specs, plans=[p and t_compiler.LayerPlan(*p) for p in plans],
        params=t_api.params_from_numpy(params_np, "cpu"), batch=2,
        backend="hopper", opt_level=opt_level, device="cpu",
        cache=ProgramCache())
    y = acc(x).numpy()
    assert state["blocks"] >= 3
    np.testing.assert_allclose(y, ref["pallas"], **TOL)
    assert np.abs(y - ref["xla"]).max() <= 1e-4 * np.abs(ref["xla"]).max()
    # the guard is live: the same call outside the kernels' plain versions
    state["pe"] += 1
    with pytest.raises(AssertionError, match="F.pad"):
        torch.nn.functional.pad(torch.zeros(1, 2), (1, 1))


def test_reduced_vgg16_hopper_fused_spatial_reads_the_map(reference_logits,
                                                          monkeypatch):
    """``opt_level=1`` on hopper: a fused Spatial layer hands K1 the stored
    map itself with all four pads (no ``slice_input_span``, so no padded
    slab), and where K1 reads it in place (``conv_implicit_f32``) the map
    reaches the kernel as it lies; the logits still match the
    reference's."""
    t_specs, plans, params_np, x, ref = reference_logits
    seen, current = {"fused": 0, "implicit": 0}, []
    fused, span = t_executor._layer_forward_fused, t_executor.slice_input_span
    implicit = conv_ops.conv_implicit_f32

    def watched(cl, w, bias, x_map, relu, **kw):
        watch = cl.plan.mode == "spat" and kw["backend"] == "hopper"
        seen["fused"] += watch
        if watch:
            current.append((cl, x_map))
        try:
            return fused(cl, w, bias, x_map, relu, **kw)
        finally:
            if watch:
                current.pop()

    def no_slab(*a, **kw):
        assert not current, "slice_input_span in a fused Spatial layer"
        return span(*a, **kw)

    def spy(x_map, *a, **kw):
        cl, whole = current[-1]
        assert x_map is whole
        assert kw["pads"] == (height_pad(cl), width_pad(cl))
        seen["implicit"] += 1
        return implicit(x_map, *a, **kw)

    monkeypatch.setattr(t_executor, "_layer_forward_fused", watched)
    monkeypatch.setattr(t_executor, "slice_input_span", no_slab)
    monkeypatch.setattr(conv_ops, "conv_implicit_f32", spy)
    acc = t_api.Accelerator.build(
        t_specs, plans=[p and t_compiler.LayerPlan(*p) for p in plans],
        params=t_api.params_from_numpy(params_np, "cpu"), batch=2,
        backend="hopper", opt_level=1, device="cpu", cache=ProgramCache())
    y = acc(x).numpy()
    assert seen["implicit"] >= 1 and seen["fused"] >= seen["implicit"]
    np.testing.assert_allclose(y, ref["pallas"], **TOL)
    assert np.abs(y - ref["xla"]).max() <= 1e-4 * np.abs(ref["xla"]).max()


def test_params_from_numpy_and_seeded_build_agree():
    """Carried-across numpy weights and the port's own seeded draw make the
    two packages compute the same logits."""
    r_specs = r_vgg.network_specs(img=32, scale=32, n_classes=10)
    t_specs = t_vgg.network_specs(img=32, scale=32, n_classes=10)
    x = np.random.default_rng(5).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    r_acc = r_api.Accelerator.build(r_specs, r_pm.V5E, batch=1, seed=4)
    y_ref = np.asarray(r_acc(jnp.asarray(x)))
    carried = t_api.params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in r_acc.params], "cpu")
    for params in (carried, None):
        acc = t_api.Accelerator.build(t_specs, t_pm.V5E, batch=1, seed=4,
                                      params=params, device="cpu")
        assert [dataclasses.astuple(p) for p in acc.plans] == \
            [dataclasses.astuple(p) for p in r_acc.plans]
        np.testing.assert_allclose(acc(x).numpy(), y_ref, **TOL)


def test_stride2_blocked_conv_matches_reference():
    """A strided SAME conv split into row groups (the halo arithmetic the
    reference fixed for strided layers) on both port backends."""
    specs = [("c1", 12, 12, 3, 8, 3, 3, 2, "SAME", True),
             ("c2", 6, 6, 8, 6, 3, 3, 1, "SAME", False)]
    plans = [("spat", "is", 2, 2, 3), ("wino", "ws", 2, 1, 2)]
    r_specs = [RConvSpec(*s) for s in specs]
    t_specs = [t_hc.ConvSpec(*s) for s in specs]
    r_params = r_api.random_params(r_specs, seed=2)
    x = np.random.default_rng(2).standard_normal((2, 12, 12, 3)).astype(
        np.float32)
    r_prog = r_compiler.compile_network(
        r_specs, [r_compiler.LayerPlan(*p) for p in plans])
    r_rt = r_api.HybridRuntime(r_prog, opt_level=0)
    r_rt.load_params(r_params)
    y_ref = np.asarray(r_rt.run(jnp.asarray(x)))
    t_prog = t_compiler.compile_network(
        t_specs, [t_compiler.LayerPlan(*p) for p in plans])
    for backend in ("torch", "hopper"):
        for opt_level in (0, 1):
            rt = HybridRuntime(t_prog, backend=backend, opt_level=opt_level,
                               device="cpu")
            rt.load_params([(np.asarray(w), np.asarray(b))
                            for w, b in r_params])
            np.testing.assert_allclose(rt.run(x).numpy(), y_ref, **TOL)


# ---------------------------------------------------------------------------
# API contract
# ---------------------------------------------------------------------------

def test_program_cache_keys_and_validation():
    _, t_specs, _, t_prog = _programs(_mixed_plans())
    cache = ProgramCache()
    e_t = cache.get(t_prog, batch=2, dtype=torch.float32, device="cpu")
    e_h = cache.get(t_prog, batch=2, dtype=torch.float32, backend="hopper",
                    device="cpu")
    e_0 = cache.get(t_prog, batch=2, dtype=torch.float32, opt_level=0,
                    device="cpu")
    assert len({id(e_t), id(e_h), id(e_0)}) == 3 and len(cache) == 3
    assert cache.get(t_prog, batch=2, dtype=torch.float32,
                     device="cpu") is e_t
    assert cache.stats.hits == 1 and cache.stats.misses == 3
    assert e_t.build_count == 1 and e_h.backend == "hopper"
    with pytest.raises(ValueError, match="unknown backend"):
        cache.get(t_prog, batch=2, dtype=torch.float32, backend="pallas",
                  device="cpu")
    with pytest.raises(ValueError, match="opt_level"):
        cache.get(t_prog, batch=2, dtype=torch.float32, opt_level=2,
                  device="cpu")


def test_executor_and_cache_take_no_default_device():
    """Each entry names its device: a default of "cpu" labelled a card's
    executor as the CPU's (a repair)."""
    _, _, _, t_prog = _programs(_mixed_plans())
    with pytest.raises(TypeError, match="device"):
        ProgramCache().get(t_prog, batch=2, dtype=torch.float32)
    with pytest.raises(TypeError, match="device"):
        cache_key(t_prog, batch=2, dtype=torch.float32)
    with pytest.raises(TypeError, match="device"):
        compile_executor(t_prog)
    entry = compile_executor(t_prog, device="cpu")
    assert entry.device == "cpu"
    with pytest.raises(TypeError, match="device"):
        CompiledExecutor(program=t_prog, stats=entry.stats, fn=entry.fn)


def _table_graph(params):
    import threading
    import weakref
    return t_executor._Graph(None, None, None,
                             tuple(weakref.ref(t) for t in params), [], {},
                             threading.Lock())


def test_graph_table_drops_least_recent_and_dead_graphs():
    """An entry's graphs, keyed by (stream, weight set): every live weight
    set keeps its graph, each weight set keeps its most recent streams (a
    lookup makes a graph the most recent, the least recently used stream
    goes past the bound), and a graph whose params are no longer
    referenced outside it is never handed out again."""
    table = t_executor._GraphTable(2)
    wa, wb, wc = (torch.zeros(2) for _ in range(3))
    ga, gb, gc = (_table_graph([w]) for w in (wa, wb, wc))
    for w, g in (("a", ga), ("b", gb), ("c", gc)):
        table.put((1, w), g)           # three weight sets on one stream
    assert len(table) == 3 and table.get((1, "a")) is ga
    a2, a3 = _table_graph([wa]), _table_graph([wa])
    table.put((2, "a"), a2)
    assert table.get((1, "a")) is ga   # stream 1 is now the most recent
    table.put((3, "a"), a3)            # a third stream of "a": stream 2 goes
    assert table.get((2, "a")) is None and len(table) == 4
    assert table.get((1, "a")) is ga and table.get((3, "a")) is a3
    assert table.get((1, "b")) is gb and table.get((1, "c")) is gc
    del wa, ga, a2, a3
    assert table.get((1, "a")) is None and len(table) == 3
    del wc, gc
    table.put((1, "b"), gb)            # a put purges dead graphs too
    assert len(table) == 1 and table.get((1, "b")) is gb


def test_capture_holds_the_multipliers_it_reads():
    """What a capture reads from the bounded multiplier cache is kept
    with the graph: an int8 lowering run under ``holding_constants``
    keeps every multiplier it used, and clearing the cache leaves them
    to the holder."""
    from repro_torch.quant import execute as q_execute
    specs = t_vgg.network_specs(img=32, scale=32, n_classes=10)
    acc = t_api.Accelerator.build(specs, t_pm.V5E, batch=1, dtype="int8",
                                  device="cpu", cache=ProgramCache())
    entry, params = acc.runtime.executor_entry(1, acc.input_dtype)
    x = torch.zeros((1, 32, 32, 3), dtype=torch.int8)
    with common.holding_constants() as held:
        y = entry.fn(params, x)
    assert held and all(t.dtype == torch.float32 for t in held)
    lq = acc.quant.layers[acc.program.layers[-1].layer_id]
    mult = q_execute.layer_multiplier(lq, torch.device("cpu"))
    assert any(t is mult for t in held)
    q_execute._layer_multiplier.cache_clear()
    assert q_execute.layer_multiplier(lq, torch.device("cpu")) is not mult
    assert torch.equal(entry.fn(params, x), y)
    # outside a capture nothing is kept
    with common.holding_constants() as held:
        pass
    q_execute.layer_multiplier(lq, torch.device("cpu"))
    assert held == []


def test_build_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    specs = t_vgg.network_specs(img=32, scale=32, n_classes=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.Accelerator.build(specs, t_pm.V5E, batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.random_params(specs)


def test_unported_paths_name_their_roadmap_item(tmp_path):
    specs = t_vgg.network_specs(img=32, scale=32, n_classes=10)
    acc = t_api.Accelerator.build(specs, t_pm.V5E, batch=1, device="cpu",
                                  cache=ProgramCache())
    # AOT bundles are ported (tests/test_torch_aot.py): a bundle of the
    # direct entry and the bucket-1 entry, loaded back bit for bit
    bundle = acc.save_program(str(tmp_path / "bundle"), aot=True)
    assert sorted(os.listdir(bundle)) == ["aot", "program.json"]
    cache = ProgramCache()
    again = t_api.Accelerator.from_program(bundle, params=acc.params,
                                           cache=cache, device="cpu")
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(again(x).numpy(), acc(x).numpy())
    assert cache.stats.aot_loads == 1
    # sharded serving is ported (tests/test_torch_mesh.py): two replicas
    # on the one CPU device, each row bit for bit the direct path on its
    # own shard
    x2 = np.concatenate([x, -x])
    with acc.serve(max_batch=2, buckets=(2,), mesh=["cpu", "cpu"]) as s:
        out = s.run_many(list(x2))
        assert s.stats.device_batches == {0: 1, 1: 1}
    for row, xi in zip(out, x2):
        np.testing.assert_array_equal(row, acc(xi[None]).numpy()[0])
    # the segmented path is ported (tests/test_torch_segmented.py)
    seg = t_api.Accelerator.build(specs, t_pm.V5E, batch=1, device="cpu",
                                  segmented=True)
    assert seg.segmented and len(seg.segment_runtimes) == 5
    # the strict interpreter is ported (tests/test_torch_strict.py)
    acc = t_api.Accelerator.build(specs, t_pm.V5E, batch=1, device="cpu",
                                  strict=True)
    assert acc.runtime.strict
    # DEPTHWISE_CONV lowers now (tests/test_torch_depthwise.py)
    dw_specs = [t_hc.ConvSpec("c1", 8, 8, 3, 4),
                t_hc.DepthwiseSpec("d1", 8, 8, 4)]
    prog = t_compiler.compile_network(
        dw_specs, [t_compiler.LayerPlan(), None])
    t_executor.validate_schedule(prog)      # validation is ported whole
    t_executor.lower_program(prog)
    # ELTWISE_ADD lowers too (ResNet-18: tests/test_torch_resnet.py)
    res_specs = [t_hc.ConvSpec("c1", 8, 8, 3, 4),
                 t_hc.ConvSpec("c2", 8, 8, 4, 4, relu=False),
                 t_hc.EltwiseSpec("e1", 8, 8, 4, skip_from=0)]
    t_executor.lower_program(t_compiler.compile_network(
        res_specs, [t_compiler.LayerPlan(), t_compiler.LayerPlan(), None]))


def test_serve_cnn_answers_on_the_cpu(capsys):
    from repro_torch.launch.serve import serve_cnn
    ys = {backend: serve_cnn(batch=2, iters=1, backend=backend, device="cpu")
          for backend in ("torch", "hopper")}
    assert ys["hopper"].shape == (2, 10) and np.isfinite(ys["hopper"]).all()
    np.testing.assert_allclose(ys["hopper"], ys["torch"], **TOL)
    out = capsys.readouterr().out
    assert "first request" in out and "images/s" in out
    with pytest.raises(ValueError, match="vgg16"):
        serve_cnn("alexnet", device="cpu")
