"""ResNet-18 in the port against the reference: the spec chain, the
compile side bit for bit (instruction images, schedule keys), the DSE plans,
the optimizer's verdicts, fp32 logits from both port backends at both opt
levels, the spec-chain oracle, and the serving launcher's int8 ResNet-18 on
the CPU. Tolerance for fp32 logits: ``rtol=atol=1e-4``, the reference's own
budget (``tests/test_backend_pallas.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as r_api  # noqa: E402
from repro.core import compiler as r_compiler  # noqa: E402
from repro.core import executor as r_executor  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core import executor as t_executor  # noqa: E402
from repro_torch.core import hybrid_conv as t_hc  # noqa: E402
from repro_torch.core import perf_model as t_pm  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.core.runtime import HybridRuntime  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
TARGETS = ["V5E", "VU9P", "PYNQ_Z1"]
BACKEND_PAIRS = [("torch", "xla"), ("hopper", "pallas")]


def _specs(img=32, scale=16, n_classes=10):
    return (r_resnet.resnet18_specs(img, scale, n_classes=n_classes),
            t_resnet.resnet18_specs(img, scale, n_classes=n_classes))


def _t_plans(r_plans):
    return [p and t_compiler.LayerPlan(*dataclasses.astuple(p))
            for p in r_plans]


def _plan_tuples(plans):
    return [p and dataclasses.astuple(p) for p in plans]


def test_resnet18_specs_match_reference():
    for img, scale, n in [(32, 16, 10), (64, 8, 10), (128, 1, 1000)]:
        r_specs, t_specs = _specs(img, scale, n)
        assert [(type(s).__name__, dataclasses.astuple(s)) for s in t_specs] \
            == [(type(s).__name__, dataclasses.astuple(s)) for s in r_specs]
    kinds = [type(s).__name__ for s in t_specs]
    assert (kinds.count("ConvSpec"), kinds.count("EltwiseSpec"),
            kinds.count("PoolSpec"), kinds.count("FCSpec")) == (20, 8, 1, 1)
    with pytest.raises(ValueError, match="divisible by 16"):
        t_resnet.resnet18_specs(40, 8)


@pytest.mark.parametrize("target", TARGETS)
def test_resnet18_dse_plans_match_reference(target):
    for size in [(32, 16, 10), (128, 1, 1000)]:
        r_specs, t_specs = _specs(*size)
        for batch in (1, 2, 8):
            r_res = getattr(r_pm, target).run_dse(r_specs, batch=batch)
            t_res = getattr(t_pm, target).run_dse(t_specs, batch=batch)
            assert _plan_tuples(t_res.plans) == _plan_tuples(r_res.plans)
    # and the int8 DSE, Winograd gated off
    r_res = getattr(r_pm, target).run_dse(r_specs, batch=8, dtype="int8")
    t_res = getattr(t_pm, target).run_dse(t_specs, batch=8, dtype="int8")
    assert _plan_tuples(t_res.plans) == _plan_tuples(r_res.plans)
    assert all(p.mode == "spat" for p, s in zip(t_res.plans, t_specs)
               if isinstance(s, t_hc.ConvSpec))


def _mixed_plans(r_specs):
    """Winograd F(2,3) on every eligible 3x3 stride-1 conv, row/k groups of
    2 on the first two: both PE paths and the blocked lowering."""
    plans, ci = [], 0
    for s in r_specs:
        if type(s).__name__ == "ConvSpec":
            wino = s.stride == 1 and s.r == 3 and ci % 2 == 1
            g = 2 if ci < 2 else 1
            plans.append(r_compiler.LayerPlan(
                "wino" if wino else "spat", "ws" if ci % 3 else "is", 2, g,
                g))
            ci += 1
        else:
            plans.append(None)
    return plans


@pytest.mark.parametrize("plans", ["dse", "mixed"])
def test_resnet18_program_matches_reference(plans):
    r_specs, t_specs = _specs()
    r_plans = (r_pm.V5E.run_dse(r_specs, batch=2).plans if plans == "dse"
               else _mixed_plans(r_specs))
    r_prog = r_compiler.compile_network(r_specs, r_plans)
    t_prog = t_compiler.compile_network(t_specs, _t_plans(r_plans))
    assert len(t_prog.instructions) == len(r_prog.instructions)
    if plans == "dse":
        assert len(t_prog.instructions) == 140
    np.testing.assert_array_equal(t_prog.instruction_image(),
                                  r_prog.instruction_image())
    assert t_prog.schedule_key() == r_prog.schedule_key()
    assert t_executor.validate_schedule(t_prog) == \
        r_executor.validate_schedule(r_prog)
    for t_backend, r_backend in BACKEND_PAIRS:
        r_v = r_executor.analyze_program(r_prog, backend=r_backend)
        t_v = t_executor.analyze_program(t_prog, backend=t_backend)
        assert {k: (v.kind, v.relu, v.relu_blocks) for k, v in t_v.items()} \
            == {k: (v.kind, v.relu, v.relu_blocks) for k, v in r_v.items()}
        assert sum(v.kind == "single" for v in t_v.values()) == 8


@pytest.fixture(scope="module")
def reference_resnet():
    """The reference's xla and pallas (interpret) logits for reduced
    ResNet-18 under mixed Spatial/Winograd plans, computed once."""
    r_specs, t_specs = _specs()
    r_plans = _mixed_plans(r_specs)
    r_params = r_api.random_params(r_specs, seed=0)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    out = {}
    for backend in ("xla", "pallas"):
        acc = r_api.Accelerator.build(r_specs, plans=r_plans, params=r_params,
                                      batch=2, backend=backend)
        out[backend] = np.asarray(acc(jnp.asarray(x)))
    out["oracle"] = np.asarray(r_resnet.reference_forward(
        r_params, jnp.asarray(x), r_specs))
    params_np = [(np.asarray(w), np.asarray(b)) for w, b in r_params]
    return t_specs, _t_plans(r_plans), params_np, x, out


@pytest.mark.parametrize("opt_level", [0, 1])
@pytest.mark.parametrize("pair", BACKEND_PAIRS, ids=lambda p: p[0])
def test_reduced_resnet18_logits_match_reference(reference_resnet, pair,
                                                 opt_level):
    t_specs, t_plans, params_np, x, ref = reference_resnet
    t_backend, r_backend = pair
    common.reset_launches()
    acc = t_api.Accelerator.build(
        t_specs, plans=t_plans, params=t_api.params_from_numpy(params_np,
                                                               "cpu"),
        batch=2, backend=t_backend, opt_level=opt_level, device="cpu",
        cache=ProgramCache())
    assert sum(p.mode == "wino" for p in t_plans if p) == 7
    y = acc(x).numpy()
    assert y.shape == (2, 10) and np.isfinite(y).all()
    np.testing.assert_allclose(y, ref[r_backend], **TOL)
    np.testing.assert_allclose(y, ref["oracle"], **TOL)
    assert common.LAUNCHES == dict.fromkeys(common.KERNELS, 0)


@pytest.mark.parametrize("opt_level", [0, 1])
def test_reduced_resnet18_hopper_winograd_copies_nothing(reference_resnet,
                                                         monkeypatch,
                                                         opt_level):
    """The hopper Winograd blocks of reduced ResNet-18 (7 layers) pad,
    gather and copy nothing around K3 and K4; the logits still match the
    reference's."""
    from test_torch_executor import guard_hopper_winograd_copies

    t_specs, t_plans, params_np, x, ref = reference_resnet
    state = guard_hopper_winograd_copies(monkeypatch)
    acc = t_api.Accelerator.build(
        t_specs, plans=t_plans, params=t_api.params_from_numpy(params_np,
                                                               "cpu"),
        batch=2, backend="hopper", opt_level=opt_level, device="cpu",
        cache=ProgramCache())
    y = acc(x).numpy()
    assert state["blocks"] >= 7
    np.testing.assert_allclose(y, ref["pallas"], **TOL)
    np.testing.assert_allclose(y, ref["oracle"], **TOL)


def test_reference_forward_matches_reference(reference_resnet):
    t_specs, _, params_np, x, ref = reference_resnet
    params = t_api.params_from_numpy(params_np, "cpu")
    y = t_resnet.reference_forward(params, torch.from_numpy(x), t_specs)
    np.testing.assert_allclose(y.numpy(), ref["oracle"], **TOL)


def test_skip_tensor_lives_until_its_eltwise_add():
    """A repair: the stash's liveness walk counted only primary inputs, so
    a skip tensor whose last primary reader runs before its ELTWISE_ADD was
    retired too early. Here layer 0 feeds layer 1 and is the skip of
    layer 2."""
    specs = [t_hc.ConvSpec("c1", 8, 8, 3, 4),
             t_hc.ConvSpec("c2", 8, 8, 4, 4, relu=False),
             t_hc.EltwiseSpec("e1", 8, 8, 4, skip_from=0)]
    prog = t_compiler.compile_network(
        specs, [t_compiler.LayerPlan(), t_compiler.LayerPlan(), None])
    params = t_api.random_params(specs, 1, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, 8, 3)).astype(np.float32))
    for backend in ("torch", "hopper"):
        rt = HybridRuntime(prog, backend=backend, device="cpu",
                           cache=ProgramCache())
        rt.load_params(params)
        np.testing.assert_allclose(
            rt.run(x).numpy(),
            t_resnet.reference_forward(params, x, specs).numpy(), **TOL)


def test_serve_resnet18_int8_on_the_cpu(capsys):
    from repro_torch.launch.serve import serve_cnn
    ys = {backend: serve_cnn("resnet18", batch=2, iters=1, backend=backend,
                             dtype="int8", device="cpu")
          for backend in ("torch", "hopper")}
    assert ys["hopper"].shape == (2, 10) and np.isfinite(ys["hopper"]).all()
    np.testing.assert_array_equal(ys["hopper"], ys["torch"])
    out = capsys.readouterr().out
    assert "dtype: int8" in out and "calibration" in out
