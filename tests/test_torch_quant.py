"""The port's int8 path against the reference's, bit for bit: the int8
scheme and observers, the ``hybriddnn-quant/v1`` sidecar, ``quantize_params``,
calibration, the int8 PE ops, the whole int8 executor on reduced VGG16 and
ResNet-18, and the int8 ``Accelerator.build`` contract.

Inputs come from numpy seeds and go to both packages. Tolerances: every
integer result and every weight scale bitwise; activation scales within
``rtol=1e-5`` (the fp32 replays that calibration observes differ in the
last bits between the packages).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as r_api  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.core.hybrid_conv import ConvSpec as RConvSpec  # noqa: E402
from repro.core.hybrid_conv import FCSpec as RFCSpec  # noqa: E402
from repro.core.hybrid_conv import PoolSpec as RPoolSpec  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.models import vgg as r_vgg  # noqa: E402
from repro.optim.compression import quantize_int8 as r_quantize_int8  # noqa: E402
from repro.quant import QuantSidecar as RQuantSidecar  # noqa: E402
from repro.quant import calibrate as r_calibrate  # noqa: E402
from repro.quant import execute as r_exec  # noqa: E402
from repro.quant import quantize_params as r_quantize_params  # noqa: E402
from repro.quant.observers import make_observer as r_make_observer  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.compat import to_tensor  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core import hybrid_conv as t_hc  # noqa: E402
from repro_torch.core import perf_model as t_pm  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.core.runtime import HybridRuntime  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402
from repro_torch.optim.compression import dequantize_int8, quantize_int8  # noqa: E402
from repro_torch.quant import (  # noqa: E402
    FORMAT,
    LayerQuant,
    QuantSidecar,
    calibrate,
    qconv2d,
    qdense,
    qdepthwise,
    qeltwise,
    quantize_params,
)
from repro_torch.quant.observers import make_observer  # noqa: E402

# the reference's 4-layer chain of tests/test_quant.py
R_SPECS = [RConvSpec("c1", 16, 16, 3, 8), RConvSpec("c2", 16, 16, 8, 16),
           RPoolSpec("p1", 16, 16, 16), RFCSpec("fc", 8 * 8 * 16, 10,
                                                relu=False)]
T_SPECS = [t_hc.ConvSpec("c1", 16, 16, 3, 8), t_hc.ConvSpec("c2", 16, 16, 8, 16),
           t_hc.PoolSpec("p1", 16, 16, 16), t_hc.FCSpec("fc", 8 * 8 * 16, 10,
                                                        relu=False)]
MODELS = ["vgg16", "resnet18"]


def _data(n=4, seed=1, img=16):
    return np.random.default_rng(seed).standard_normal(
        (n, img, img, 3)).astype(np.float32)


def _specs(model):
    if model == "vgg16":
        return (r_vgg.network_specs(img=32, scale=16, n_classes=10),
                t_vgg.network_specs(img=32, scale=16, n_classes=10))
    return (r_resnet.resnet18_specs(img=32, scale=16, n_classes=10),
            t_resnet.resnet18_specs(img=32, scale=16, n_classes=10))


def _np_params(params):
    return [(np.asarray(w), np.asarray(b)) for w, b in params]


def _assert_sidecars_match(t_sc, r_sc):
    """Weight scales and kinds bit for bit, activation scales to 1e-5."""
    assert len(t_sc.layers) == len(r_sc.layers)
    assert t_sc.observer == r_sc.observer
    np.testing.assert_allclose(t_sc.input_scale, r_sc.input_scale, rtol=1e-5)
    for t_lq, r_lq in zip(t_sc.layers, r_sc.layers):
        assert (t_lq.kind, t_lq.requantize) == (r_lq.kind, r_lq.requantize)
        assert t_lq.wgt_scale == r_lq.wgt_scale
        for f in ("in_scale", "out_scale", "skip_scale"):
            a, b = getattr(t_lq, f), getattr(r_lq, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f)


@pytest.fixture(scope="module", params=MODELS)
def reference_int8(request):
    """The reference's int8 accelerator for a reduced model (fixed calib),
    its int8 input and its logits, built once per model."""
    r_specs, t_specs = _specs(request.param)
    params = r_api.random_params(r_specs, seed=3)
    calib = _data(4, seed=2, img=32)
    a8 = r_api.Accelerator.build(r_specs, target=r_pm.V5E, batch=2,
                                 params=params, dtype="int8", calib=calib)
    q = a8.quant.quantize_input(jnp.asarray(_data(2, img=32)))
    return dict(model=request.param, r_specs=r_specs, t_specs=t_specs,
                params=_np_params(params), calib=calib, acc=a8,
                q=np.array(q), y=np.asarray(a8._request(q)))


# ---------------------------------------------------------------------------
# 1. the int8 scheme and the observers
# ---------------------------------------------------------------------------

def test_quantize_int8_and_observers_match_reference():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((3, 17, 5)).astype(np.float32) * 3,
              np.concatenate([np.linspace(-1, 1, 10_000), [1000.0]]),
              rng.standard_normal(4099).astype(np.float32) * 1e-3]
    for x in arrays:
        q, s = quantize_int8(x)
        r_q, r_s = r_quantize_int8(jnp.asarray(x, jnp.float32))
        assert s.dtype == np.float32 and s == np.float32(r_s)
        np.testing.assert_array_equal(q, np.asarray(r_q))
        np.testing.assert_array_equal(dequantize_int8(q, s),
                                      q.astype(np.float32) * s)
    for kind in ("minmax", "percentile"):
        t_obs, r_obs = make_observer(kind), r_make_observer(kind)
        for x in arrays:
            t_obs.observe(torch.from_numpy(np.asarray(x, np.float32)))
            r_obs.observe(jnp.asarray(x))
        assert t_obs.scale == r_obs.scale, kind
    with pytest.raises(ValueError, match="observer"):
        make_observer("entropy")
    with pytest.raises(ValueError, match="calibrate first"):
        _ = make_observer("minmax").scale


# ---------------------------------------------------------------------------
# 2. the sidecar
# ---------------------------------------------------------------------------

def test_sidecar_round_trips_between_the_packages():
    params = r_api.random_params(R_SPECS, seed=0)
    r_sc = r_calibrate(R_SPECS, params, _data())
    doc = r_sc.to_dict()
    t_sc = QuantSidecar.from_dict(doc)
    assert t_sc.to_dict() == doc and FORMAT == doc["format"]
    assert RQuantSidecar.from_dict(t_sc.to_dict()) == r_sc
    t_prog = t_compiler.compile_network(
        T_SPECS, t_pm.V5E.run_dse(T_SPECS, batch=2, dtype="int8").plans)
    key = t_prog.schedule_key()
    assert t_sc.digest() == r_sc.digest()
    assert t_sc.digest(key) == r_sc.digest(key) != t_sc.digest()
    for t_lq, r_lq in zip(t_sc.layers, r_sc.layers):
        if t_lq.wgt_scale is None:
            continue
        m, r_m = t_lq.multiplier, r_lq.multiplier
        assert m.dtype == np.float32
        np.testing.assert_array_equal(m, r_m)
        # per-tensor: a Python double product, cast to float32 where used
        pt = dataclasses.replace(t_lq, wgt_scale=t_lq.wgt_scale[0])
        r_pt = dataclasses.replace(r_lq, wgt_scale=r_lq.wgt_scale[0])
        assert isinstance(pt.multiplier, float)
        assert pt.multiplier == r_pt.multiplier
    bad = dict(doc, format="hybriddnn-quant/v0")
    with pytest.raises(ValueError, match="unsupported quant sidecar format"):
        QuantSidecar.from_dict(bad)
    # the network-edge conversions
    x = _data(2)
    np.testing.assert_array_equal(
        t_sc.quantize_input(torch.from_numpy(x)).numpy(),
        np.asarray(r_sc.quantize_input(jnp.asarray(x))))
    y = torch.arange(-127, 128, dtype=torch.int8)
    np.testing.assert_array_equal(
        t_sc.dequantize_output(y).numpy(),
        np.asarray(r_sc.dequantize_output(jnp.asarray(y.numpy()))))


# ---------------------------------------------------------------------------
# 3-4. quantize_params and calibrate
# ---------------------------------------------------------------------------

def test_quantize_params_matches_reference(reference_int8):
    ref = reference_int8
    sc = QuantSidecar.from_dict(ref["acc"].quant.to_dict())
    t_q = quantize_params(ref["t_specs"], ref["params"], sc, device="cpu")
    r_q = r_quantize_params(ref["r_specs"], ref["params"], ref["acc"].quant)
    assert len(t_q) == len(r_q)
    for (tw, tb), (rw, rb) in zip(t_q, r_q):
        assert (tw.dtype, tb.dtype) == (torch.int8, torch.int32)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    with pytest.raises(ValueError, match="mismatch"):
        quantize_params(ref["t_specs"], ref["params"] + ref["params"][:1], sc)


def test_calibrate_matches_reference(reference_int8):
    ref = reference_int8
    t_sc = calibrate(ref["t_specs"], ref["params"], ref["calib"])
    _assert_sidecars_match(t_sc, ref["acc"].quant)
    assert [lq.kind for lq in t_sc.layers].count("eltwise") == (
        8 if ref["model"] == "resnet18" else 0)


@pytest.mark.parametrize("observer", ["minmax", "percentile"])
def test_calibrate_small_chain_both_observers(observer):
    params = r_api.random_params(R_SPECS, seed=0)
    batches = [_data(4, seed=1), _data(3, seed=5)]
    r_sc = r_calibrate(R_SPECS, params, batches, observer=observer)
    t_params = [(to_tensor(w, "cpu"), to_tensor(b, "cpu"))
                for w, b in _np_params(params)]
    t_sc = calibrate(T_SPECS, t_params, batches, observer=observer)
    _assert_sidecars_match(t_sc, r_sc)
    assert t_sc.layers[2].in_scale == t_sc.layers[2].out_scale  # POOL
    with pytest.raises(ValueError, match="at least one"):
        calibrate(T_SPECS, params, [])


# ---------------------------------------------------------------------------
# 6. the int8 PE ops, both port backends against both reference paths
# ---------------------------------------------------------------------------

QCONV_CASES = [
    # (h, w, c, k, r, stride, padding, relu)
    (9, 9, 3, 8, 3, 1, "SAME", True),
    (10, 10, 5, 7, 3, 2, "SAME", False),       # strided SAME: asymmetric pads
    (12, 12, 6, 4, 1, 2, "SAME", False),       # 1x1 projection, stride 2
    (8, 8, 4, 6, 1, 1, "VALID", True),
    (8, 8, 4, 6, 3, 1, ((0, 0), (1, 1)), True),  # the executor's pads
    (7, 9, 3, 5, 3, 1, ((1, 2), (0, 1)), False),
]


@pytest.mark.parametrize("case", QCONV_CASES, ids=str)
def test_qconv2d_matches_reference(case):
    h, w, c, k, r, stride, padding, relu = case
    rng = np.random.default_rng(h * 10 + k)
    x = rng.integers(-127, 128, (2, h, w, c), dtype=np.int8)
    g = rng.integers(-127, 128, (r, r, c, k), dtype=np.int8)
    b = rng.integers(-3000, 3000, k, dtype=np.int32)
    mult = rng.random(k).astype(np.float32) * np.float32(1e-3)
    refs = [np.asarray(r_exec.qconv2d(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), mult=mult,
        stride=stride, padding=padding, relu=relu, use_pallas=p,
        interpret=True if p else None)) for p in (False, True)]
    np.testing.assert_array_equal(refs[0], refs[1])
    for backend in ("torch", "hopper"):
        y = qconv2d(torch.from_numpy(x), torch.from_numpy(g),
                    torch.from_numpy(b), mult=torch.from_numpy(mult),
                    stride=stride, padding=padding, relu=relu,
                    backend=backend)
        assert y.dtype == torch.int8
        np.testing.assert_array_equal(y.numpy(), refs[0])


@pytest.mark.parametrize("per_channel", [False, True])
def test_qdense_and_qeltwise_match_reference(per_channel):
    rng = np.random.default_rng(per_channel)
    x = rng.integers(-127, 128, (3, 300), dtype=np.int8)
    w = rng.integers(-127, 128, (300, 37), dtype=np.int8)
    b = rng.integers(-3000, 3000, 37, dtype=np.int32)
    mult = (rng.random(37).astype(np.float32) * np.float32(1e-4)
            if per_channel else 3.1e-5)
    for relu in (False, True):
        refs = [np.asarray(r_exec.qdense(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mult=mult,
            relu=relu, use_pallas=p, interpret=True if p else None))
            for p in (False, True)]
        np.testing.assert_array_equal(refs[0], refs[1])
        for backend in ("torch", "hopper"):
            y = qdense(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), mult=mult, relu=relu,
                       backend=backend)
            np.testing.assert_array_equal(y.numpy(), refs[0])
    a = rng.integers(-127, 128, (2, 5, 5, 6), dtype=np.int8)
    s = rng.integers(-127, 128, (2, 5, 5, 6), dtype=np.int8)
    lq = LayerQuant("eltwise", 0.031, 0.047, skip_scale=0.029)
    for relu in (False, True):
        np.testing.assert_array_equal(
            qeltwise(torch.from_numpy(a), torch.from_numpy(s), lq,
                     relu).numpy(),
            np.asarray(r_exec.qeltwise(jnp.asarray(a), jnp.asarray(s),
                                       lq, relu)))
    # qdepthwise is ported (tests/test_torch_depthwise.py): per-tensor mult
    w = rng.integers(-127, 128, (3, 3, 1, 6), dtype=np.int8)
    bd = rng.integers(-3000, 3000, 6, dtype=np.int32)
    for relu in (False, True):
        np.testing.assert_array_equal(
            qdepthwise(torch.from_numpy(a), torch.from_numpy(w),
                       torch.from_numpy(bd), mult=3.1e-3, relu=relu).numpy(),
            np.asarray(r_exec.qdepthwise(jnp.asarray(a), jnp.asarray(w),
                                         jnp.asarray(bd), mult=3.1e-3,
                                         relu=relu)))


# ---------------------------------------------------------------------------
# 7. the slice as a whole: int8 logits bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_level", [0, 1])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_int8_executor_matches_reference_bitwise(reference_int8, backend,
                                                 opt_level):
    """The reference's sidecar, quantized params and program (recompiled by
    the port from the same specs and plans) give the reference's int8
    logits bit for bit."""
    ref = reference_int8
    a8 = ref["acc"]
    prog = t_compiler.compile_network(
        ref["t_specs"],
        [t_compiler.LayerPlan(*dataclasses.astuple(p)) for p in a8.plans])
    assert prog.schedule_key() == a8.program.schedule_key()
    rt = HybridRuntime(prog, backend=backend, opt_level=opt_level,
                       device="cpu", cache=ProgramCache(),
                       quant=QuantSidecar.from_dict(a8.quant.to_dict()))
    rt.load_params(_np_params(a8.params))
    assert rt.dram_params()[0][0].dtype == torch.int8
    common.reset_launches()
    y = rt.run(torch.from_numpy(ref["q"]))
    assert y.dtype == torch.int8 and y.shape == (2, 10)
    np.testing.assert_array_equal(y.numpy(), ref["y"])
    # a float input is quantized at the input scale on the way in
    np.testing.assert_array_equal(rt.run(_data(2, img=32)).numpy(),
                                  ref["y"])
    assert common.LAUNCHES["qmm_i8"] == 0      # CPU: plain versions only


# ---------------------------------------------------------------------------
# 8. the int8 Accelerator.build contract
# ---------------------------------------------------------------------------

def test_int8_build_contract():
    cache = ProgramCache()
    a8 = t_api.Accelerator.build(T_SPECS, t_pm.V5E, batch=2, seed=0,
                                 dtype="int8", calib=_data(8, seed=2),
                                 device="cpu", cache=cache)
    assert a8.quant is not None and a8.input_dtype == torch.int8
    assert a8.calib_ms is not None
    assert all(p.mode == "spat" for p, s in zip(a8.plans, T_SPECS)
               if isinstance(s, t_hc.ConvSpec))
    x = _data(3)
    y = a8(x)                                # float in, float out
    assert y.dtype == torch.float32 and y.shape == (3, 10)
    q = a8.quant.quantize_input(torch.from_numpy(x))
    y_q = a8.runtime.run(q)                  # int8 passes through unchanged
    np.testing.assert_array_equal(a8(q).numpy(),
                                  a8.quant.dequantize_output(y_q).numpy())
    np.testing.assert_array_equal(
        y.numpy(), (y_q.float() * np.float32(a8.quant.output_scale)).numpy())
    # another calibration of the same Program: its own cache entry
    b8 = t_api.Accelerator.build(T_SPECS, t_pm.V5E, batch=2, seed=0,
                                 dtype="int8", calib=_data(8, seed=9),
                                 device="cpu", cache=cache)
    b8(x)
    assert b8.program.schedule_key() == a8.program.schedule_key()
    assert b8.quant.digest() != a8.quant.digest() and len(cache) == 2
    with pytest.raises(ValueError, match="fp32-only"):
        t_api.Accelerator.build(T_SPECS, t_pm.V5E, batch=2, dtype="int8",
                                segmented=True, device="cpu")
    with pytest.raises(ValueError, match="unsupported dtype"):
        t_api.Accelerator.build(T_SPECS, t_pm.V5E, batch=2, dtype="int4",
                                device="cpu")


def test_int8_default_calibration_matches_reference():
    """The default calib draw is the reference's, bit for bit: the port's
    default build equals a build on that explicit draw, and its sidecar
    matches the reference's default one."""
    r_a8 = r_api.Accelerator.build(R_SPECS, target=r_pm.V5E, batch=2, seed=4,
                                   dtype="int8")
    t_a8 = t_api.Accelerator.build(T_SPECS, t_pm.V5E, batch=2, seed=4,
                                   dtype="int8", device="cpu")
    draw = np.random.default_rng(5).standard_normal((8, 16, 16, 3)).astype(
        np.float32)
    explicit = t_api.Accelerator.build(T_SPECS, t_pm.V5E, batch=2, seed=4,
                                       dtype="int8", calib=draw,
                                       device="cpu")
    assert explicit.quant == t_a8.quant
    _assert_sidecars_match(t_a8.quant, r_a8.quant)
    assert [dataclasses.astuple(p) for p in t_a8.plans] == \
        [dataclasses.astuple(p) for p in r_a8.plans]


# ---------------------------------------------------------------------------
# 10. the repairs this slice needed
# ---------------------------------------------------------------------------

def test_to_tensor_keeps_integer_types():
    assert to_tensor(np.zeros(3, np.int8), "cpu").dtype == torch.int8
    assert to_tensor(np.zeros(3, np.int32), "cpu").dtype == torch.int32
    assert to_tensor(np.zeros(3, np.float64), "cpu").dtype == torch.float32
    assert to_tensor([1.5, 2.0], "cpu").dtype == torch.float32
    assert to_tensor(np.zeros(3, np.int8), "cpu",
                     torch.float32).dtype == torch.float32
    carried = t_api.params_from_numpy(
        [(np.ones((3, 3, 2, 4), np.int8), np.ones(4, np.int32))], "cpu")
    assert [t.dtype for t in carried[0]] == [torch.int8, torch.int32]
