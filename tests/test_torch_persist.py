"""Persistence across the two packages: ``Accelerator.save_program`` /
``from_program`` (the ``hybriddnn-program/v1`` document with the
``hybriddnn-quant/v1`` sidecar) and ``summary()``.

A program saved by either package loads in the other, fp32 and int8, on
reduced VGG16 and ResNet-18 built through the DSE (``pm.V5E``, batch 2):
the JSON documents are equal key for key, the instruction images bit for
bit, and the logits agree within the reference's fp32 budget
``rtol=atol=1e-4`` (``tests/test_backend_pallas.py``) on both port
backends, int8 bit for bit. Every tampered file raises
``ProgramLoadError`` with the reference's cause, and ``summary()`` is the
reference's text character for character under the three planning
targets. Weights and inputs are made once with numpy and go to both
packages.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as r_api  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro.models import vgg as r_vgg  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import perf_model as t_pm  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ("vgg16", "resnet18")
CASES = [(m, d) for m in MODELS for d in ("float32", "int8")]


def _specs(model):
    if model == "vgg16":
        return (r_vgg.network_specs(img=32, scale=16, n_classes=10),
                t_vgg.network_specs(img=32, scale=16, n_classes=10))
    return (r_resnet.resnet18_specs(img=32, scale=16, n_classes=10),
            t_resnet.resnet18_specs(img=32, scale=16, n_classes=10))


def _x():
    return np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


def _calib():
    return np.random.default_rng(2).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)


def _np(params):
    return [(np.asarray(w), np.asarray(b)) for w, b in params]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def saved(request, tmp_path_factory):
    """One reduced model and dtype built by the reference (and saved), its
    fp32 weights as numpy, and its logits on a fixed input."""
    model, dtype = request.param
    r_specs, t_specs = _specs(model)
    params = _np(r_api.random_params(r_specs, seed=3))
    acc = r_api.Accelerator.build(
        r_specs, r_pm.V5E, batch=2, params=params, dtype=dtype,
        calib=_calib() if dtype == "int8" else None)
    path = str(tmp_path_factory.mktemp("persist") / f"{model}-{dtype}.json")
    acc.save_program(path)
    return dict(model=model, dtype=dtype, path=path, t_specs=t_specs,
                params=params, y=np.asarray(acc(jnp.asarray(_x()))),
                image=acc.program.instruction_image())


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_reference_program_loads_in_the_port(saved, backend):
    acc = t_api.Accelerator.from_program(
        saved["path"], params=saved["params"], backend=backend,
        device="cpu", cache=ProgramCache())
    np.testing.assert_array_equal(acc.program.instruction_image(),
                                  saved["image"])
    y = acc(_x()).numpy()
    if saved["dtype"] == "int8":
        np.testing.assert_array_equal(y, saved["y"])
    else:
        np.testing.assert_allclose(y, saved["y"], **TOL)
    assert acc.target == "v5e" and acc.dse is not None


def test_port_program_loads_in_the_reference(saved, tmp_path):
    """The port builds the same model (same weights, same calibration
    data), saves it, and the reference loads and serves that file."""
    acc = t_api.Accelerator.build(
        saved["t_specs"], t_pm.V5E, batch=2, params=saved["params"],
        dtype=saved["dtype"], calib=_calib() if saved["dtype"] == "int8"
        else None, device="cpu", cache=ProgramCache())
    path = acc.save_program(str(tmp_path / "port.json"))
    y_port = acc(_x()).numpy()
    r_acc = r_api.Accelerator.from_program(path, params=saved["params"])
    np.testing.assert_array_equal(r_acc.program.instruction_image(),
                                  saved["image"])
    y_ref = np.asarray(r_acc(jnp.asarray(_x())))
    if saved["dtype"] == "int8":
        # the port's own calibration replays fp32 in another order, so its
        # scales sit within 1e-5 of the reference's; the reference serves
        # the port's sidecar here, so the two agree bit for bit
        np.testing.assert_array_equal(y_port, y_ref)
    else:
        np.testing.assert_allclose(y_port, y_ref, **TOL)
        # fp32: the documents are equal key for key
        assert _load(path) == _load(saved["path"])


def test_resaved_document_equals_the_reference_key_for_key(saved, tmp_path):
    """A reference document loaded in the port and saved again is the same
    document, int8 sidecar and its schedule-bound digest included."""
    acc = t_api.Accelerator.from_program(
        saved["path"], params=saved["params"], device="cpu",
        cache=ProgramCache())
    path = acc.save_program(str(tmp_path / "again.json"))
    a, b = _load(path), _load(saved["path"])
    assert list(a) == list(b)
    assert a == b
    assert acc.summary() == r_api.Accelerator.from_program(
        saved["path"], params=saved["params"]).summary()


# -- refusals ------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_doc(tmp_path_factory):
    """A port-saved int8 program (reduced VGG16) and its weights."""
    _, t_specs = _specs("vgg16")
    params = _np(r_api.random_params(_specs("vgg16")[0], seed=3))
    acc = t_api.Accelerator.build(t_specs, t_pm.V5E, batch=2, params=params,
                                  dtype="int8", calib=_calib(), device="cpu",
                                  cache=ProgramCache())
    path = str(tmp_path_factory.mktemp("refuse") / "int8.json")
    acc.save_program(path)
    return path, params, acc


def _both_refuse(path, params, match):
    """Both packages refuse ``path`` with the same cause."""
    with pytest.raises(t_api.ProgramLoadError, match=match):
        t_api.Accelerator.from_program(path, params=params, device="cpu")
    with pytest.raises(r_api.ProgramLoadError, match=match):
        r_api.Accelerator.from_program(path, params=params)


def test_truncated_json_is_refused(int8_doc, tmp_path):
    path, params, _ = int8_doc
    bad = tmp_path / "cut.json"
    bad.write_text(open(path).read()[:-100])
    _both_refuse(str(bad), params, "truncated or not JSON")


def test_unknown_format_is_refused(int8_doc, tmp_path):
    path, params, _ = int8_doc
    doc = _load(path)
    doc["format"] = "hybriddnn-program/v0"
    bad = tmp_path / "fmt.json"
    bad.write_text(json.dumps(doc))
    _both_refuse(str(bad), params, "not a hybriddnn-program/v1 file")


def test_stream_drift_is_refused(int8_doc, tmp_path):
    path, params, _ = int8_doc
    doc = _load(path)
    doc["instructions"][0][2] ^= 1          # flip a DRAM_BASE bit
    bad = tmp_path / "drift.json"
    bad.write_text(json.dumps(doc))
    _both_refuse(str(bad), params, "does not match its recompilation")


def test_sidecar_bound_to_another_schedule_is_refused(int8_doc, tmp_path):
    path, params, _ = int8_doc
    doc = _load(path)
    doc["quant"]["sidecar"]["input_scale"] *= 1.5   # edited calibration
    bad = tmp_path / "sidecar.json"
    bad.write_text(json.dumps(doc))
    _both_refuse(str(bad), params, "quant sidecar digest does not match")
    # a sidecar pasted from another program: its digest names that schedule
    doc = _load(path)
    doc["quant"]["digest"] = "0" * 16
    bad.write_text(json.dumps(doc))
    _both_refuse(str(bad), params, "quant sidecar digest does not match")


def test_int8_program_takes_fp32_weights_or_the_quantized_image(int8_doc):
    path, params, acc = int8_doc
    y = acc(_x()).numpy()
    for weights in (params, acc.params):
        again = t_api.Accelerator.from_program(
            path, params=weights, device="cpu", cache=ProgramCache())
        assert again.params[0][0].dtype == torch.int8
        np.testing.assert_array_equal(again(_x()).numpy(), y)


def test_directory_without_program_json_is_refused(int8_doc, tmp_path):
    _, params, _ = int8_doc
    _both_refuse(str(tmp_path), params, "no program.json inside")


def test_missing_params_and_aot_are_refused(int8_doc, tmp_path):
    path, params, acc = int8_doc
    with pytest.raises(ValueError, match="carry no weights"):
        t_api.Accelerator.from_program(path, device="cpu")
    # a bundle directory: program.json loads, and so does one with an
    # empty aot/ inside (no artifact: every entry is built fresh)
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    (bundle / "program.json").write_text(open(path).read())
    loaded = t_api.Accelerator.from_program(str(bundle), params=params,
                                            device="cpu")
    np.testing.assert_array_equal(loaded(_x()).numpy(), acc(_x()).numpy())
    os.mkdir(bundle / "aot")
    cache = ProgramCache()
    loaded = t_api.Accelerator.from_program(str(bundle), params=params,
                                            device="cpu", cache=cache)
    np.testing.assert_array_equal(loaded(_x()).numpy(), acc(_x()).numpy())
    assert cache.stats.aot_loads == 0 and cache.stats.misses == 1
    # save_program(aot=True) writes the int8 bundle (tests/test_torch_aot.py
    # holds its loads); a strict accelerator has no executor to export
    saved = acc.save_program(str(tmp_path / "int8_bundle"), aot=True)
    assert json.load(open(os.path.join(saved, "program.json"))) == \
        json.load(open(path))
    strict = t_api.Accelerator.from_program(path, params=params,
                                            device="cpu", strict=True)
    with pytest.raises(ValueError, match="strict-interpreter"):
        strict.save_program(str(tmp_path / "strict"), aot=True)
    assert issubclass(t_api.ProgramLoadError, ValueError)   # broad callers


# -- summary -------------------------------------------------------------------

TARGETS = {"v5e": (r_pm.V5E, t_pm.V5E), "vu9p": (r_pm.VU9P, t_pm.VU9P),
           "pynq": (r_pm.PYNQ_Z1, t_pm.PYNQ_Z1)}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("target", sorted(TARGETS))
def test_summary_text_equals_the_reference(model, target):
    r_specs, t_specs = _specs(model)
    r_t, t_t = TARGETS[target]
    r_acc = r_api.Accelerator.build(r_specs, r_t, batch=2, seed=0)
    t_acc = t_api.Accelerator.build(t_specs, t_t, batch=2, seed=0,
                                    device="cpu", cache=ProgramCache())
    assert t_acc.summary() == r_acc.summary()
    assert "est. total" in t_acc.summary()


def test_summary_of_an_int8_build_and_of_supplied_plans():
    r_specs, t_specs = _specs("vgg16")
    r_acc = r_api.Accelerator.build(r_specs, r_pm.V5E, batch=2, seed=0,
                                    dtype="int8", calib=_calib())
    t_acc = t_api.Accelerator.build(t_specs, t_pm.V5E, batch=2, seed=0,
                                    dtype="int8", calib=_calib(),
                                    device="cpu", cache=ProgramCache())
    assert t_acc.summary() == r_acc.summary()
    assert "int8+rq" in t_acc.summary()
    r_fixed = r_api.Accelerator.build(r_specs, plans=r_acc.plans, seed=0)
    t_fixed = t_api.Accelerator.build(
        t_specs, plans=t_acc.plans, seed=0, device="cpu",
        cache=ProgramCache())
    assert t_fixed.summary() == r_fixed.summary()
    assert "plans supplied (no DSE)" in t_fixed.summary()
