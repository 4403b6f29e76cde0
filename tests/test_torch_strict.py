"""The port's strict per-instruction interpreter against its own executor and
the reference's interpreter: reduced VGG16 and ResNet-18 in fp32 and int8
on both port backends, the DRAM replay and the Winograd SAVE layout,
``Accelerator.build(strict=True)`` and ``strict_request()``, and the serve
CLI's ``--compare-interpreter``.

Params and inputs are made once with numpy (the reference's
``api.random_params`` and ``default_rng`` draws, and its calibration) and
go to both packages. Tolerances: the interpreter equals the port's
``opt_level=0`` executor bit for bit (the same PE calls on the same
shapes); against ``opt_level=1`` and against the reference's interpreter,
int8 bit for bit and fp32 within ``rtol=atol=1e-4``, the reference's own
fp32 budget (``tests/test_backend_pallas.py``).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as r_api  # noqa: E402
from repro.core import compiler as r_compiler  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.core.hybrid_conv import ConvSpec as RConvSpec  # noqa: E402
from repro.core.hybrid_conv import FCSpec as RFCSpec  # noqa: E402
from repro.core.hybrid_conv import PoolSpec as RPoolSpec  # noqa: E402
from repro.core.runtime import HybridRuntime as RHybridRuntime  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.models import vgg as r_vgg  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core import executor as t_executor  # noqa: E402
from repro_torch.core import hybrid_conv as t_hc  # noqa: E402
from repro_torch.core import layouts  # noqa: E402
from repro_torch.core import perf_model as t_pm  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.core.runtime import (  # noqa: E402
    HybridRuntime,
    run_program,
)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402
from repro_torch.quant import QuantSidecar  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = Path(__file__).resolve().parents[1]


def _specs(model):
    if model == "vgg16":
        return (r_vgg.network_specs(img=32, scale=16, n_classes=10),
                t_vgg.network_specs(img=32, scale=16, n_classes=10))
    return (r_resnet.resnet18_specs(img=32, scale=16, n_classes=10),
            t_resnet.resnet18_specs(img=32, scale=16, n_classes=10))


def _plans(specs, int8: bool):
    """Winograd (m = 2) on every other eligible CONV in fp32, IS/WS in
    turn, 2x2 row/k groups on the first two CONVs: the interpreter's
    ping-pong slots, both SAVE assemblies, the per-k-group multiplier
    slices and the Winograd SAVE layout."""
    plans, ci = [], 0
    for s in specs:
        if isinstance(s, RConvSpec):
            g = 2 if ci < 2 else 1
            wino = not int8 and ci % 2 == 0 and s.wino_eligible(2)
            plans.append(("wino" if wino else "spat",
                          "is" if ci % 2 else "ws", 2, g, g))
            ci += 1
        else:
            plans.append(None)
    return plans


def _np(params):
    return [(np.asarray(w), np.asarray(b)) for w, b in params]


CASES = [(m, d) for m in ("vgg16", "resnet18") for d in ("float32", "int8")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def reference_strict(request):
    """The reference's strict interpreter on one reduced model and dtype:
    its output, its stats and its final DRAM activations, run once."""
    model, dtype = request.param
    r_specs, t_specs = _specs(model)
    plans = _plans(r_specs, dtype == "int8")
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    calib = np.random.default_rng(2).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    acc = r_api.Accelerator.build(
        r_specs, plans=[p and r_compiler.LayerPlan(*p) for p in plans],
        params=r_api.random_params(r_specs, seed=3), batch=2, dtype=dtype,
        calib=calib if dtype == "int8" else None)
    inp = (x if acc.quant is None
           else np.array(acc.quant.quantize_input(jnp.asarray(x))))
    rt = RHybridRuntime(acc.program, strict=True, quant=acc.quant)
    rt.load_params(acc.params)
    y = np.asarray(rt.run(jnp.asarray(inp)))
    wino_addrs = {cl.out_addr for cl in acc.program.layers
                  if cl.out_layout == "wino"}
    return dict(t_specs=t_specs, plans=plans, program=acc.program,
                params=_np(acc.params), inp=inp, y=y, stats=dict(rt.stats),
                quant=None if acc.quant is None else acc.quant.to_dict(),
                wino_dram={a: np.asarray(rt.dram[a]) for a in wino_addrs})


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_strict_interpreter_matches_executor_and_reference(reference_strict,
                                                           backend):
    ref = reference_strict
    prog = t_compiler.compile_network(
        ref["t_specs"], [p and t_compiler.LayerPlan(*p) for p in ref["plans"]])
    assert prog.schedule_key() == ref["program"].schedule_key()
    quant = None if ref["quant"] is None else QuantSidecar.from_dict(
        ref["quant"])
    inp = torch.from_numpy(ref["inp"])

    def runtime(**kw):
        rt = HybridRuntime(prog, backend=backend, device="cpu", quant=quant,
                           cache=ProgramCache(), **kw)
        rt.load_params(ref["params"])
        return rt

    common.reset_launches()
    st = runtime(strict=True)
    y = st.run(inp)
    assert y.dtype == (torch.float32 if quant is None else torch.int8)
    assert tuple(y.shape) == (2, 10)
    # the same PE calls on the same shapes as the literal lowering
    assert torch.equal(y, runtime(opt_level=0).run(inp))
    y1 = runtime(opt_level=1).run(inp)
    if quant is None:
        np.testing.assert_allclose(y1.numpy(), y.numpy(), **TOL)
        np.testing.assert_allclose(y.numpy(), ref["y"], **TOL)
    else:
        assert torch.equal(y1, y)
        np.testing.assert_array_equal(y.numpy(), ref["y"])
    assert st.stats == t_executor.validate_schedule(prog) == ref["stats"]
    # the Winograd SAVE layout: the same tile-major DRAM image
    assert bool(ref["wino_dram"]) == (quant is None)
    for addr, r_img in ref["wino_dram"].items():
        img = st.dram[addr]
        assert tuple(img.shape) == r_img.shape
        np.testing.assert_allclose(img.numpy(), r_img, **TOL)
    assert common.LAUNCHES == dict.fromkeys(common.KERNELS, 0)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_strict_replays_from_dram_and_round_trips_wino_layout(backend):
    """test_hazards' two-CONV net planned Winograd on both layers (2 row
    groups, then 2 k-groups): the input and the first layer's output live
    in DRAM tile-major.
    ``run()`` with no input replays from DRAM, ``run_program`` gives the
    same output; both packages add every run to ``stats``."""
    specs = [RConvSpec("c1", 16, 16, 3, 8, relu=True),
             RConvSpec("c2", 16, 16, 8, 12, relu=False)]
    params = r_api.random_params(specs, seed=4)
    x = np.random.default_rng(9).standard_normal((1, 16, 16, 3)).astype(
        np.float32)
    plans = [("wino", "is", 2, 1, 2), ("wino", "ws", 4, 2, 1)]
    r_rt = RHybridRuntime(r_compiler.compile_network(
        specs, [r_compiler.LayerPlan(*p) for p in plans]), strict=True)
    r_rt.load_params(params)
    r_y = np.asarray(r_rt.run(jnp.asarray(x)))
    assert np.array_equal(np.asarray(r_rt.run()), r_y)

    t_specs = [t_hc.ConvSpec(**dataclasses.asdict(s)) for s in specs]
    prog = t_compiler.compile_network(
        t_specs, [t_compiler.LayerPlan(*p) for p in plans])
    rt = HybridRuntime(prog, strict=True, backend=backend, device="cpu")
    rt.load_params(_np(params))
    y = rt.run(x)
    assert torch.equal(rt.run(), y)
    np.testing.assert_allclose(y.numpy(), r_y, **TOL)
    # the one-call form, as the reference's tests use it
    assert torch.equal(run_program(prog, _np(params), x, strict=True,
                                   backend=backend, device="cpu"), y)
    assert rt.stats == r_rt.stats
    assert rt.stats == {k: 2 * v for k, v in
                        t_executor.validate_schedule(prog).items()}
    l0, l1 = prog.layers
    assert (l0.inp_layout, l0.out_layout) == ("wino", "wino")
    for addr, hw, m in ((l0.inp_addr, (16, 16), 2), (l0.out_addr, (16, 16),
                                                     4)):
        img = rt.dram[addr]
        assert img.dim() == 6 and img.shape[3:5] == (m, m)
        np.testing.assert_allclose(img.numpy(), np.asarray(r_rt.dram[addr]),
                                   **TOL)
        nhwc = layouts.load_view(img, "wino", hw=hw)
        assert torch.equal(layouts.save_transform(nhwc, "wino", m), img)


# ---------------------------------------------------------------------------
# Accelerator.build(strict=True) and strict_request()
# ---------------------------------------------------------------------------

# the reference's 4-layer chain of tests/test_api.py
R_SPECS = [RConvSpec("c1", 16, 16, 3, 8), RConvSpec("c2", 16, 16, 8, 16),
           RPoolSpec("p1", 16, 16, 16), RFCSpec("fc", 8 * 8 * 16, 10,
                                                relu=False)]
T_SPECS = [t_hc.ConvSpec("c1", 16, 16, 3, 8),
           t_hc.ConvSpec("c2", 16, 16, 8, 16),
           t_hc.PoolSpec("p1", 16, 16, 16),
           t_hc.FCSpec("fc", 8 * 8 * 16, 10, relu=False)]


def _x(batch=2, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_strict_build_and_strict_request_match_reference(backend):
    """tests/test_api.py:50-59 on the port: the FPGA-planned Program's
    executor equals its interpreter bit for bit, and a strict accelerator
    answers through the interpreter, as the reference's does."""
    x = _x()
    r_acc = r_api.Accelerator.build(R_SPECS, target=r_pm.PYNQ_Z1, batch=2,
                                    seed=0)
    r_strict = r_api.Accelerator.build(R_SPECS, target=r_pm.PYNQ_Z1,
                                       batch=2, seed=0, strict=True)
    y_r = np.asarray(r_strict(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(r_acc(jnp.asarray(x))), y_r)

    acc = t_api.Accelerator.build(T_SPECS, t_pm.PYNQ_Z1, batch=2, seed=0,
                                  backend=backend, device="cpu",
                                  cache=ProgramCache())
    cache = ProgramCache()
    strict = t_api.Accelerator.build(T_SPECS, t_pm.PYNQ_Z1, batch=2, seed=0,
                                     backend=backend, strict=True,
                                     device="cpu", cache=cache)
    assert strict.runtime.strict and strict.backend == backend
    assert cache.validated_size == 0       # no build-time validation
    y = acc(x)
    y_s = strict(x)
    np.testing.assert_allclose(y_s.numpy(), y_r, **TOL)
    assert torch.equal(y_s, _strict_run(acc, backend, x))
    # strict_request: the torch PE, the same device, whatever the backend
    req = acc.strict_request()
    assert req.__self__.backend == "torch" and req.__self__.strict
    assert req.__self__.device == acc.device
    y_q = req(x)
    np.testing.assert_allclose(y_q.numpy(), y_r, **TOL)
    if backend == "torch":
        assert torch.equal(y, y_q)
    with pytest.raises(RuntimeError, match="no cached executor"):
        strict.runtime.executor_entry(2)


def _strict_run(acc, backend, x):
    """``acc``'s program and params on a fresh strict runtime."""
    rt = HybridRuntime(acc.program, strict=True, backend=backend,
                       device="cpu")
    rt.load_params(acc.params)
    return rt.run(x)


def test_int8_executor_matches_strict_request_bitwise():
    """tests/test_quant.py:154-158 on the port, both backends: the strict
    interpreter carries the sidecar, so its int8 logits equal the
    executor's bit for bit, and a strict int8 build stays float-in/out."""
    calib = _x(8, seed=2)
    for backend in ("torch", "hopper"):
        a8 = t_api.Accelerator.build(T_SPECS, t_pm.V5E, batch=2, seed=0,
                                     dtype="int8", calib=calib,
                                     backend=backend, device="cpu",
                                     cache=ProgramCache())
        q = a8.quant.quantize_input(torch.from_numpy(_x()))
        y = a8.runtime.run(q)
        assert y.dtype == torch.int8
        assert torch.equal(y, a8.strict_request()(q))
        s8 = t_api.Accelerator.build(T_SPECS, t_pm.V5E, batch=2, seed=0,
                                     dtype="int8", calib=calib,
                                     backend=backend, strict=True,
                                     device="cpu")
        assert torch.equal(s8(_x()), a8(_x()))


# ---------------------------------------------------------------------------
# the serve CLI's --compare-interpreter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_serve_cli_compare_interpreter(dtype):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "vgg16",
         "--reduced", "--device", "cpu", "--compare-interpreter",
         "--backend", "hopper", "--dtype", dtype, "--batch", "2",
         "--iters", "2"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
        check=True).stdout
    m = re.search(r"interpreter: [\d.]+ms/batch \([\d.]+x slower than "
                  r"cached executor; max \|diff\| (\S+); max \|logit\| "
                  r"(\S+)\)", out)
    assert m, out
    diff, logit = float(m.group(1)), float(m.group(2))
    if dtype == "int8":
        assert m.group(1) == "0.00e+00"
    else:
        # the hopper executor (the kernels' plain versions on the CPU)
        # against the torch interpreter
        assert diff <= 1e-3 * logit
    assert "logits: (2, 10)" in out
