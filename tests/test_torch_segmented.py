"""The legacy multi-Program path (``Accelerator.build(segmented=True)``:
one Program per CONV segment, a host maxpool between segments, the FC tail
through ``hybrid_conv.dense``) and the VGG16 model builders
(``conv_segments``, ``default_plans``, ``accelerator``, ``init_params``,
``forward``, ``params_from_numpy``), against the reference.

Tolerances: on the CPU the segmented path equals the port's single-Program
path bit for bit on both backends (the same PE calls on the same shapes,
as the reference holds its two paths, ``tests/test_integration.py``);
against the reference's segmented path and ``vgg.forward`` the port stays
within the reference's fp32 budget ``rtol=atol=1e-4``
(``tests/test_backend_pallas.py``). Weights and inputs are made once with
numpy and go to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as r_api  # noqa: E402
from repro.core import compiler as r_compiler  # noqa: E402
from repro.core.hybrid_conv import ConvSpec as RConvSpec  # noqa: E402
from repro.core.hybrid_conv import EltwiseSpec as REltwiseSpec  # noqa: E402
from repro.core.hybrid_conv import FCSpec as RFCSpec  # noqa: E402
from repro.core.hybrid_conv import PoolSpec as RPoolSpec  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.models import vgg as r_vgg  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core import perf_model as t_pm  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec, EltwiseSpec  # noqa: E402
from repro_torch.core.hybrid_conv import FCSpec, PoolSpec  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
IMG, SCALE = 32, 16


def _plans(specs, mod):
    """Winograd (m = 2) and Spatial in turn, WS and IS in turn: the
    reference's own mix (``tests/test_integration.py``), so the
    single-Program path runs the POOL -> WINO layout reorder and the
    U-space weights."""
    plans, ci = [], 0
    for s in specs:
        if type(s).__name__ == "ConvSpec":
            plans.append(mod.LayerPlan("wino" if ci % 2 == 0 else "spat",
                                       "is" if ci % 2 else "ws", m=2))
            ci += 1
        else:
            plans.append(None)
    return plans


def _x(n=2):
    return np.random.default_rng(1).standard_normal(
        (n, IMG, IMG, 3)).astype(np.float32)


def _np(params):
    return [(np.asarray(w), np.asarray(b)) for w, b in params]


@pytest.fixture(scope="module")
def reference():
    specs = r_vgg.network_specs(img=IMG, scale=SCALE, n_classes=10)
    plans = _plans(specs, r_compiler)
    params = _np(r_api.random_params(specs, seed=0))
    acc = r_api.Accelerator.build(specs, plans=plans, params=params,
                                  batch=2, segmented=True)
    return dict(params=params, y=np.asarray(acc(jnp.asarray(_x()))),
                summary=acc.summary(), n=acc.n_instructions)


# -- the chain check -----------------------------------------------------------

def _chains(conv, pool, fc, elt):
    return {
        "trailing CONV": [conv("c1", 16, 16, 3, 8), pool("p", 16, 16, 8),
                          conv("c2", 8, 8, 8, 8), fc("fc", 8 * 8 * 8, 4)],
        "without a preceding CONV": [pool("p", 16, 16, 3),
                                     conv("c1", 8, 8, 3, 8),
                                     pool("p2", 8, 8, 8),
                                     fc("fc", 4 * 4 * 8, 4)],
        "CONV after the FC tail": [conv("c1", 16, 16, 3, 8),
                                   pool("p", 16, 16, 8),
                                   fc("fc", 8 * 8 * 8, 4),
                                   conv("c2", 8, 8, 8, 8)],
        "POOL after the FC tail": [conv("c1", 16, 16, 3, 8),
                                   pool("p", 16, 16, 8),
                                   fc("fc", 8 * 8 * 8, 4),
                                   pool("p2", 8, 8, 8)],
        "reroutes its input": [conv("c1", 16, 16, 3, 8),
                               conv("c2", 16, 16, 3, 8, inp_from=-1),
                               pool("p", 16, 16, 8)],
        "residual adds": [conv("c1", 16, 16, 3, 8),
                          elt("a", 16, 16, 8, skip_from=0),
                          pool("p", 16, 16, 8)],
        "no CONV\\+POOL segment": [fc("fc", 16, 4)],
    }


@pytest.mark.parametrize("cause", sorted(_chains(
    RConvSpec, RPoolSpec, RFCSpec, REltwiseSpec)))
def test_segments_of_raises_the_reference_errors(cause):
    """The port's ``_conv_segments_of`` refuses every chain the
    reference refuses, with the same message."""
    r_chain = _chains(RConvSpec, RPoolSpec, RFCSpec, REltwiseSpec)[cause]
    t_chain = _chains(ConvSpec, PoolSpec, FCSpec, EltwiseSpec)[cause]
    with pytest.raises(ValueError, match=cause) as r_exc:
        r_api._conv_segments_of(r_chain)
    with pytest.raises(ValueError, match=cause) as t_exc:
        t_api._conv_segments_of(t_chain)
    assert str(t_exc.value) == str(r_exc.value)


def test_segmented_rejects_non_vgg_chains_at_build():
    """The reference's ``test_segmented_rejects_non_vgg_chains``."""
    plans = [t_compiler.LayerPlan("spat", "is")] * 2 + [None, None]
    with pytest.raises(ValueError, match="trailing CONV"):
        t_api.Accelerator.build(
            [ConvSpec("c1", 16, 16, 3, 8), PoolSpec("p", 16, 16, 8),
             ConvSpec("c2", 8, 8, 8, 8), FCSpec("fc", 8 * 8 * 8, 4)],
            plans=plans, segmented=True, device="cpu")
    with pytest.raises(ValueError, match="without a preceding CONV"):
        t_api.Accelerator.build(
            [PoolSpec("p", 16, 16, 3), ConvSpec("c1", 8, 8, 3, 8),
             PoolSpec("p2", 8, 8, 8), FCSpec("fc", 4 * 4 * 8, 4)],
            plans=plans, segmented=True, device="cpu")
    with pytest.raises(ValueError, match="fp32-only"):
        t_api.Accelerator.build(
            t_vgg.network_specs(IMG, SCALE, n_classes=10), t_pm.V5E,
            segmented=True, dtype="int8", device="cpu")
    assert t_vgg.conv_segments() == r_vgg.conv_segments() == [2, 2, 3, 3, 3]
    assert t_api._conv_segments_of(t_vgg.network_specs()) == \
        t_vgg.conv_segments()


# -- segmented == single Program == the reference ------------------------------

@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_segmented_equals_single_program_and_the_reference(reference,
                                                           backend):
    specs = t_vgg.network_specs(img=IMG, scale=SCALE, n_classes=10)
    plans = _plans(specs, t_compiler)
    kw = dict(plans=plans, params=reference["params"], batch=2,
              backend=backend, device="cpu", cache=ProgramCache())
    single = t_api.Accelerator.build(specs, **kw)
    common.reset_launches()
    seg = t_api.Accelerator.build(specs, segmented=True, **kw)
    y_seg = seg(_x())
    if backend == "hopper":      # the FC tail runs K2's plain version
        assert common.LAUNCHES["bmm_f32"] == 0   # (the CPU: no launch)
    np.testing.assert_array_equal(y_seg.numpy(), single(_x()).numpy())
    np.testing.assert_allclose(y_seg.numpy(), reference["y"], **TOL)
    assert seg.segmented and len(seg.segment_runtimes) == 5
    assert seg.program is None and seg.runtime is None
    assert seg.n_instructions == reference["n"]
    assert seg.summary() == reference["summary"]
    assert "5 segment Programs + host glue" in seg.summary()
    # the interpreter over the same segments: bit for bit on the torch PE
    strict = seg.strict_request()(_x())
    if backend == "torch":
        np.testing.assert_array_equal(strict.numpy(), y_seg.numpy())
    with pytest.raises(ValueError, match="multiple Programs"):
        seg.save_program("unused.json")


def test_segmented_session_serves_through_the_request(reference):
    """A segmented accelerator serves a session through ``acc(x)`` (no
    executor entry per bucket), bit for bit on the full bucket."""
    specs = t_vgg.network_specs(img=IMG, scale=SCALE, n_classes=10)
    seg = t_api.Accelerator.build(
        specs, plans=_plans(specs, t_compiler), params=reference["params"],
        batch=2, segmented=True, device="cpu", cache=ProgramCache())
    with seg.serve(max_batch=2, buckets=(2,), warmup=True) as s:
        out = s.run_many([_x()])
        assert not s._entries
    np.testing.assert_array_equal(out[0], seg(_x()).numpy())


# -- the model builders ---------------------------------------------------------

def test_vgg_forward_on_carried_weights_matches_the_reference():
    """``vgg.forward`` (the raw per-layer path) on the reference's
    ``init_params`` tree, carried across with ``params_from_numpy``: both
    port backends within 1e-4 of the reference's XLA forward (IS plans,
    the only dataflow its XLA path takes)."""
    tree = r_vgg.init_params(jax.random.PRNGKey(0), img=IMG, scale=SCALE,
                             n_classes=10)
    tree_np = jax.tree.map(np.asarray, tree)
    plans = [r_compiler.LayerPlan("wino" if i % 3 == 0 else "spat", "is",
                                  m=2 if i % 2 else 4)
             for i in range(13)]
    y_ref = np.asarray(r_vgg.forward(tree, jnp.asarray(_x()), plans))
    t_tree = t_vgg.params_from_numpy(tree_np, "cpu")
    t_plans = [t_compiler.LayerPlan(p.mode, p.dataflow, m=p.m)
               for p in plans]
    for backend in ("torch", "hopper"):
        y = t_vgg.forward(t_tree, torch.from_numpy(_x()), t_plans,
                          backend=backend)
        np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    # WS plans run on the kernels' path only, as in the reference
    ws = [t_compiler.LayerPlan(p.mode, "ws", m=p.m) for p in t_plans]
    y_ws = t_vgg.forward(t_tree, torch.from_numpy(_x()), ws,
                         backend="hopper")
    np.testing.assert_allclose(y_ws.numpy(), y_ref, **TOL)
    with pytest.raises(ValueError, match="dataflow"):
        t_vgg.forward(t_tree, torch.from_numpy(_x()), ws, backend="torch")


def test_vgg_init_params_shapes_and_cfg_refusal():
    gen = torch.Generator().manual_seed(0)
    tree = t_vgg.init_params(gen, img=IMG, scale=SCALE, n_classes=10,
                             device="cpu")
    ref = r_vgg.init_params(jax.random.PRNGKey(0), img=IMG, scale=SCALE,
                            n_classes=10)
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == shapes
    assert all(c["w"].dtype == torch.float32 for c in tree["convs"])
    again = t_vgg.init_params(torch.Generator().manual_seed(0), img=IMG,
                              scale=SCALE, n_classes=10, device="cpu")
    assert torch.equal(again["fc3"]["w"], tree["fc3"]["w"])   # seeded
    with pytest.raises(ValueError, match="ModelConfig"):
        t_vgg.init_params(gen, object(), device="cpu")
    with pytest.raises(ValueError, match="ModelConfig"):
        r_vgg.init_params(jax.random.PRNGKey(0), object())
    y = t_vgg.forward(tree, torch.from_numpy(_x()),
                      t_vgg.default_plans(t_vgg.conv_specs(IMG, SCALE),
                                          batch=2),
                      backend="hopper")
    assert tuple(y.shape) == (2, 10) and torch.isfinite(y).all()


def test_default_plans_and_accelerator_builders_match_the_reference():
    specs = t_vgg.conv_specs(IMG, SCALE)
    assert ([tuple(vars(p).values()) for p in t_vgg.default_plans(
        specs, batch=2)]
        == [tuple(vars(p).values()) for p in r_vgg.default_plans(
            r_vgg.conv_specs(IMG, SCALE), batch=2)])
    for t_mod, r_mod, kw in ((t_vgg, r_vgg, dict(img=IMG, scale=SCALE,
                                                  n_classes=10)),
                             (t_resnet, r_resnet, {})):
        t_acc = t_mod.accelerator(batch=2, device="cpu", backend="hopper",
                                  cache=ProgramCache(), **kw)
        r_acc = r_mod.accelerator(batch=2, **kw)
        assert t_acc.summary() == r_acc.summary()
        np.testing.assert_array_equal(t_acc.program.instruction_image(),
                                      r_acc.program.instruction_image())
        assert t_acc.backend == "hopper" and t_acc.device.type == "cpu"


# -- the serve CLI's --segmented ------------------------------------------------

def test_serve_cnn_segmented_flag_matches_default(capsys):
    """``serve_cnn``'s ``--segmented`` path end to end (DSE plans, random
    params) equals the single-Program default bit for bit, as in the
    reference (``tests/test_integration.py``)."""
    from repro_torch.launch import serve as t_serve
    y1 = t_serve.serve_cnn("vgg16", batch=2, iters=1, seed=3, device="cpu")
    y2 = t_serve.serve_cnn("vgg16", batch=2, iters=1, seed=3, device="cpu",
                           segmented=True)
    np.testing.assert_array_equal(y1, y2)
    out = capsys.readouterr().out
    assert "segment Programs + host glue" in out
    with pytest.raises(ValueError, match="resnet18 serves single-Program"):
        t_serve.serve_cnn("resnet18", device="cpu", segmented=True)
