"""The port's depthwise path against the reference's: ``depthwise_conv2d``
and ``qdepthwise`` op by op, and the conv -> depthwise -> depthwise(stride
2) -> FC chain of ``tests/test_residual_ops.py`` through
``Accelerator.build`` on both port backends and both opt levels, fp32 and
int8.

Params and inputs are made once with numpy (the reference's
``api.random_params``, a ``default_rng`` draw) and go to both packages.
Tolerances: the fp32 op within ``rtol=atol=1e-5`` (the reference's own
op-level budget, ``tests/test_residual_ops.py``), the fp32 chain's logits
within ``rtol=atol=1e-4``; every int8 result and every weight scale bit for
bit, activation scales within ``rtol=1e-5`` (the fp32 replays calibration
observes differ in the last bits between the packages).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as r_api  # noqa: E402
from repro.core import executor as r_executor  # noqa: E402
from repro.core import hybrid_conv as r_hc  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.quant import execute as r_exec  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core import executor as t_executor  # noqa: E402
from repro_torch.core import hybrid_conv as t_hc  # noqa: E402
from repro_torch.core import perf_model as t_pm  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.core.runtime import HybridRuntime  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models.resnet import reference_forward  # noqa: E402
from repro_torch.quant import (  # noqa: E402
    QuantSidecar,
    calibrate,
    qdepthwise,
    quantize_params,
)

OP_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
BACKEND_PAIRS = [("torch", "xla"), ("hopper", "pallas")]


def _chain(hc):
    """The chain of tests/test_residual_ops.py, in either package."""
    return [hc.ConvSpec("c1", 8, 8, 3, 6, relu=True),
            hc.DepthwiseSpec("d1", 8, 8, 6, relu=True),
            hc.DepthwiseSpec("d2", 8, 8, 6, stride=2, relu=False),
            hc.FCSpec("f1", 4 * 4 * 6, 5)]


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv2d_matches_reference(stride, padding, relu):
    # H even and W odd: under stride 2, SAME pads (0, 1) rows, (1, 1) cols
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 8, 7, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = np.asarray(r_hc.depthwise_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
        padding=padding, relu=relu))
    y = t_hc.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), stride=stride,
                              padding=padding, relu=relu)
    assert y.dtype == torch.float32 and tuple(y.shape) == ref.shape
    np.testing.assert_allclose(y.numpy(), ref, **OP_TOL)


def test_depthwise_conv2d_rejects_a_bad_kernel_like_reference():
    x = np.zeros((1, 8, 8, 5), np.float32)
    for shape in [(3, 3, 5, 5), (3, 3, 1, 4)]:
        w = np.zeros(shape, np.float32)
        with pytest.raises(ValueError, match="depthwise kernel") as r_err:
            r_hc.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w))
        with pytest.raises(ValueError, match="depthwise kernel") as t_err:
            t_hc.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w))
        assert str(t_err.value) == str(r_err.value)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_qdepthwise_matches_reference(stride, relu):
    rng = np.random.default_rng(10 + stride)
    x = rng.integers(-127, 128, (2, 8, 7, 6), dtype=np.int8)
    x[:, :3, :, 0], x[:, 3:, :, 1] = 127, -127        # the int8 extremes
    w = rng.integers(-127, 128, (3, 3, 1, 6), dtype=np.int8)
    w[..., 0, 0], w[..., 0, 1] = 127, -127
    b = rng.integers(-20000, 20000, 6, dtype=np.int32)
    mult = 1.3e-3                  # spreads the sums over int8, clips some
    for padding in ("SAME", "VALID"):
        ref = np.asarray(r_exec.qdepthwise(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mult=mult,
            stride=stride, padding=padding, relu=relu))
        y = qdepthwise(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), mult=mult, stride=stride,
                       padding=padding, relu=relu)
        assert y.dtype == torch.int8
        np.testing.assert_array_equal(y.numpy(), ref)
        assert np.abs(ref.astype(np.int32)).max() == 127


# ---------------------------------------------------------------------------
# the chain through Accelerator.build
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_chain():
    """The reference's fp32 and int8 accelerators for the chain (V5E
    plans), their inputs and logits, built once."""
    r_specs = _chain(r_hc)
    params = r_api.random_params(r_specs, seed=0)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    calib = np.random.default_rng(4).standard_normal((4, 8, 8, 3)).astype(
        np.float32)
    acc = r_api.Accelerator.build(r_specs, target=r_pm.V5E, batch=2,
                                  params=params)
    a8 = r_api.Accelerator.build(r_specs, target=r_pm.V5E, batch=2,
                                 params=params, dtype="int8", calib=calib)
    q = a8.quant.quantize_input(jnp.asarray(x))
    return dict(params=[(np.asarray(w), np.asarray(b)) for w, b in params],
                x=x, calib=calib, acc=acc, y=np.asarray(acc(jnp.asarray(x))),
                a8=a8, q=np.array(q), y8=np.asarray(a8._request(q)))


def _port_program(r_acc):
    """The port's program for the reference accelerator's plans."""
    prog = t_compiler.compile_network(
        _chain(t_hc),
        [p and t_compiler.LayerPlan(*dataclasses.astuple(p))
         for p in r_acc.plans])
    assert prog.schedule_key() == r_acc.program.schedule_key()
    return prog


@pytest.mark.parametrize("opt_level", [0, 1])
@pytest.mark.parametrize("pair", BACKEND_PAIRS, ids=lambda p: p[0])
def test_depthwise_chain_fp32_matches_reference(reference_chain, pair,
                                                opt_level):
    ref = reference_chain
    t_backend, r_backend = pair
    common.reset_launches()
    acc = t_api.Accelerator.build(
        _chain(t_hc), t_pm.V5E, batch=2,
        params=t_api.params_from_numpy(ref["params"], "cpu"),
        backend=t_backend, opt_level=opt_level, device="cpu",
        cache=ProgramCache())
    assert [dataclasses.astuple(p) for p in acc.plans] == \
        [dataclasses.astuple(p) for p in ref["acc"].plans]
    y = acc(ref["x"])
    assert tuple(y.shape) == (2, 5)
    np.testing.assert_allclose(y.numpy(), ref["y"], **TOL)
    # the port's executor against its own strict interpreter, bit for bit
    rt = HybridRuntime(acc.program, strict=True, backend=t_backend,
                       device="cpu")
    rt.load_params(acc.params)
    assert torch.equal(rt.run(ref["x"]), y)
    assert rt.stats == t_executor.validate_schedule(acc.program) == \
        r_executor.validate_schedule(ref["acc"].program)
    if t_backend == "torch":
        # as the reference asserts: executor == strict interpreter ==
        # the spec-chain oracle, bitwise (all aten)
        x = torch.from_numpy(ref["x"])
        assert torch.equal(acc.strict_request()(x), y)
        assert torch.equal(reference_forward(acc.params, x, acc.specs), y)
    # the verdict tables, depthwise layers "single"
    t_v = t_executor.analyze_program(acc.program, backend=t_backend)
    r_v = r_executor.analyze_program(ref["acc"].program, backend=r_backend)
    assert {k: (v.kind, v.relu, v.reason) for k, v in t_v.items()} == \
        {k: (v.kind, v.relu, v.reason) for k, v in r_v.items()}
    assert [t_v[i].kind for i in (1, 2)] == ["single", "single"]
    assert common.LAUNCHES == dict.fromkeys(common.KERNELS, 0)


def test_depthwise_chain_calibration_matches_reference(reference_chain):
    ref = reference_chain
    r_sc = ref["a8"].quant
    params = t_api.params_from_numpy(ref["params"], "cpu")
    t_sc = calibrate(_chain(t_hc), params, ref["calib"])
    assert [lq.kind for lq in t_sc.layers] == ["conv", "dw", "dw", "fc"]
    np.testing.assert_allclose(t_sc.input_scale, r_sc.input_scale,
                               rtol=1e-5)
    for t_lq, r_lq in zip(t_sc.layers, r_sc.layers):
        assert (t_lq.kind, t_lq.requantize) == (r_lq.kind, r_lq.requantize)
        # weight scales bit for bit: per tensor (a float) for depthwise
        assert t_lq.wgt_scale == r_lq.wgt_scale
        np.testing.assert_allclose(t_lq.in_scale, r_lq.in_scale, rtol=1e-5)
        np.testing.assert_allclose(t_lq.out_scale, r_lq.out_scale,
                                   rtol=1e-5)
    assert isinstance(t_sc.layers[1].wgt_scale, float)
    # quantize_params on the reference's sidecar: its int8 image exactly
    q_params = quantize_params(_chain(t_hc), params,
                               QuantSidecar.from_dict(r_sc.to_dict()))
    for (tw, tb), (rw, rb) in zip(q_params, ref["a8"].params):
        assert tw.dtype == torch.int8 and tb.dtype == torch.int32
        np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    # and the port's own int8 build serves the chain float-in/float-out
    a8 = t_api.Accelerator.build(_chain(t_hc), t_pm.V5E, batch=2,
                                 params=params, dtype="int8",
                                 calib=ref["calib"], device="cpu",
                                 cache=ProgramCache())
    y = a8(ref["x"])
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, 5)
    assert np.abs(y.numpy() - ref["y"]).max() < 0.5


@pytest.mark.parametrize("opt_level", [0, 1])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_depthwise_chain_int8_matches_reference(reference_chain, backend,
                                                opt_level):
    """The reference's sidecar and int8 params on the port's program: its
    int8 logits bit for bit, from the executor and the interpreter."""
    ref = reference_chain
    a8 = ref["a8"]
    prog = _port_program(a8)
    quant = QuantSidecar.from_dict(a8.quant.to_dict())
    params = [(np.asarray(w), np.asarray(b)) for w, b in a8.params]
    q = torch.from_numpy(ref["q"])
    rt = HybridRuntime(prog, backend=backend, opt_level=opt_level,
                       device="cpu", cache=ProgramCache(), quant=quant)
    rt.load_params(params)
    y = rt.run(q)
    assert y.dtype == torch.int8
    np.testing.assert_array_equal(y.numpy(), ref["y8"])
    st = HybridRuntime(prog, strict=True, backend=backend, device="cpu",
                       quant=quant)
    st.load_params(params)
    assert torch.equal(st.run(q), y)
    # a float input is quantized at the sidecar's input scale on the way in
    assert torch.equal(st.run(ref["x"]), y)
