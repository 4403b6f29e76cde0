"""AOT bundles of the port (``repro_torch.core.aot``), mirroring
``tests/test_aot_export.py``.

* **bitwise warm-load** — an entry loaded from a saved bundle (a
  ``torch.export`` artifact) answers bit for bit as the freshly lowered
  one, over {torch, hopper} x {fp32, int8} x {opt_level 0, 1}, with
  ``SessionStats.compile_ms`` exactly zero and both buckets loaded;
* **stale-key fallback** — the device's name, the torch version, the
  kernel library's digest, the schedule and the quant digest each make a
  load fall back with the stale dimension named on the ``repro_torch.aot``
  log, and the fresh build answers bit for bit;
* **damaged bundles** — a truncated artifact, a tampered manifest and the
  fault harness's ``aot_load`` site fall back the same way;
* **across packages** — a bundle saved by either package loads in the
  other: its ``program.json`` serves, its ``aot/`` reads as stale (format
  and environment) with a warning;
* **keys** — ``donate_input`` is a key dimension of the program cache and
  of the artifact, and ``executor_entry(donate_input=)`` hands back the
  donating entry.

Every case runs on the CPU (``device="cpu"``; the hopper kernels' plain
versions), where no entry is captured into a CUDA graph.
"""
import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as r_api  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.core.hybrid_conv import ConvSpec as RConvSpec  # noqa: E402
from repro.core.hybrid_conv import FCSpec as RFCSpec  # noqa: E402
from repro.core.hybrid_conv import PoolSpec as RPoolSpec  # noqa: E402
from repro.core.program_cache import ProgramCache as RProgramCache  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import aot  # noqa: E402
from repro_torch.core import perf_model as pm  # noqa: E402
from repro_torch.core.compiler import LayerPlan, compile_network  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec, FCSpec, PoolSpec  # noqa: E402
from repro_torch.core.program_cache import ProgramCache, cache_key  # noqa: E402
from repro_torch.serving import FaultPlan, FaultSpec  # noqa: E402

SPECS = [ConvSpec("c1", 8, 8, 3, 8), PoolSpec("p1", 8, 8, 8),
         FCSpec("fc", 4 * 4 * 8, 10, relu=False)]
R_SPECS = [RConvSpec("c1", 8, 8, 3, 8), RPoolSpec("p1", 8, 8, 8),
           RFCSpec("fc", 4 * 4 * 8, 10, relu=False)]
BATCH = 2
FALLBACK = "falling back to a fresh build"


def _calib(dtype):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
            if dtype == "int8" else None)


def _build(backend="torch", dtype="fp32", opt_level=1):
    return api.Accelerator.build(
        SPECS, target=pm.V5E, batch=BATCH, seed=0, backend=backend,
        opt_level=opt_level,
        dtype="float32" if dtype == "fp32" else dtype, calib=_calib(dtype),
        device="cpu", cache=ProgramCache())


def _requests(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((8, 8, 3)).astype(np.float32)
            for _ in range(n)]


# --------------------------------------------------------------------------
# bitwise warm-load across the full matrix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("opt_level", [0, 1])
def test_warm_load_bitwise_matrix(tmp_path, backend, dtype, opt_level):
    """Loaded entries are bit for bit the freshly lowered ones, and the
    warm session lowers nothing (compile_ms == 0)."""
    acc = _build(backend, dtype, opt_level)
    reqs = _requests(2 * BATCH)
    with acc.serve(max_batch=BATCH, buckets=(1, BATCH), warmup=True) as s:
        fresh = [np.asarray(y) for y in s.run_many(reqs)]
        assert s.stats.compile_ms > 0          # this one DID lower
        assert s.stats.warm_load_ms == 0.0

    bundle = str(tmp_path / "bundle")
    assert acc.save_program(bundle, aot=True, buckets=(1, BATCH)) == bundle
    assert len(aot.read_manifest(os.path.join(bundle, "aot"))) == 3
    warm_cache = ProgramCache()               # no in-process entries: every
    acc2 = api.Accelerator.from_program(       # lookup must hit the disk
        bundle, params=acc.params, cache=warm_cache, backend=backend,
        opt_level=opt_level, device="cpu")
    with acc2.serve(max_batch=BATCH, buckets=(1, BATCH), warmup=True) as s:
        warm = [np.asarray(y) for y in s.run_many(reqs)]
        st = s.stats
    assert warm_cache.stats.aot_loads >= 2     # both buckets loaded
    assert st.compile_ms == 0.0                # NOTHING lowered
    assert st.warm_load_ms > 0.0
    for a, b in zip(fresh, warm):
        np.testing.assert_array_equal(a, b)    # bitwise, not allclose

    # the direct acc(x) entry loads too, and no entry was captured here
    x = np.stack(_requests(BATCH, seed=9))
    np.testing.assert_array_equal(np.asarray(acc(x)), np.asarray(acc2(x)))
    assert warm_cache.stats.aot_loads == 3
    entry, _ = acc2.runtime.executor_entry(BATCH, acc2.input_dtype)
    assert entry.aot_loaded and entry.build_count == 0
    assert entry.trace_count == 0


# --------------------------------------------------------------------------
# stale-key dimensions: fallback + logged reason, never a wrong answer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    acc = _build()
    path = str(tmp_path_factory.mktemp("aot") / "bundle")
    acc.save_program(path, aot=True, buckets=(1, BATCH))
    return acc, path


def _key_for(acc, batch=BATCH, donate=False):
    rt = acc.runtime
    params = rt.dram_params()
    return cache_key(rt.program, batch=batch, dtype=acc.input_dtype,
                     param_dtypes=tuple(str(w.dtype) for w, _ in params),
                     backend=rt.backend, opt_level=rt.opt_level,
                     donate_input=donate, device=rt.device, quant=rt.quant)


def _load_expect_fallback(aot_dir, key, caplog, reason_substr, env=None):
    with caplog.at_level(logging.INFO, logger="repro_torch.aot"):
        fn = aot.load_entry(aot_dir, key, env=env)
    assert fn is None
    text = caplog.text
    assert FALLBACK in text
    assert reason_substr in text
    return text


def test_the_bundle_loads_with_a_matching_key(bundle):
    """A matching key loads the artifact, which holds the program and not
    the weights (no example inputs saved with it)."""
    acc, path = bundle
    aot_dir = os.path.join(path, "aot")
    digest = aot.artifact_digest(aot.artifact_key(_key_for(acc)))
    ep = torch.export.load(os.path.join(aot_dir, f"{digest}.pt2"))
    assert ep.example_inputs is None
    fn = aot.load_entry(aot_dir, _key_for(acc))
    assert fn is not None
    x = torch.from_numpy(np.stack(_requests(BATCH, seed=4)))
    params = acc.runtime.dram_params()
    np.testing.assert_array_equal(fn(params, x).numpy(),
                                  np.asarray(acc(x)))


@pytest.mark.parametrize("dim,value", [
    ("device_name", "NVIDIA H100 80GB HBM3"),
    ("torch_version", "0.0.1"),
    ("kernel_digest", "0123456789abcdef"),
])
def test_stale_environment_falls_back(bundle, caplog, dim, value):
    acc, path = bundle
    env = dict(aot.environment_fingerprint("cpu"), **{dim: value})
    _load_expect_fallback(os.path.join(path, "aot"), _key_for(acc),
                          caplog, dim, env=env)


def test_stale_torch_version_falls_back_end_to_end(bundle, caplog,
                                                   monkeypatch):
    """Version drift detected end to end: a bundle saved under another
    torch release builds fresh, and the fresh answers stay bit for bit
    right, because the fallback is the ordinary lowering."""
    acc, path = bundle
    env = dict(aot.environment_fingerprint("cpu"), torch_version="0.0.1",
               cuda_version="0.0")
    monkeypatch.setattr(aot, "environment_fingerprint",
                        lambda device="cpu": env)
    fresh_cache = ProgramCache()
    with caplog.at_level(logging.WARNING, logger="repro_torch.aot"):
        acc2 = api.Accelerator.from_program(path, params=acc.params,
                                            cache=fresh_cache, device="cpu")
        x = np.stack(_requests(BATCH, seed=3))
        np.testing.assert_array_equal(np.asarray(acc(x)),
                                      np.asarray(acc2(x)))
    assert fresh_cache.stats.aot_loads == 0    # every artifact was stale
    assert "torch_version" in caplog.text and FALLBACK in caplog.text


def test_stale_schedule_falls_back(bundle, caplog):
    """A different instruction stream never picks up the old artifact."""
    acc, path = bundle
    other = compile_network(
        [ConvSpec("c1", 8, 8, 3, 8, relu=False)],
        [LayerPlan("spat", "ws", m=2, g_k=1, g_h=1)])
    key = list(_key_for(acc))
    key[0] = other.schedule_key()
    _load_expect_fallback(os.path.join(path, "aot"), tuple(key),
                          caplog, "schedule")


def test_stale_quant_digest_falls_back(bundle, caplog):
    acc, path = bundle
    key = list(_key_for(acc))
    key[8] = "deadbeefdeadbeef"                # quant digest dimension
    _load_expect_fallback(os.path.join(path, "aot"), tuple(key),
                          caplog, "quant_digest")


def test_truncated_artifact_falls_back(bundle, caplog):
    acc, path = bundle
    aot_dir = os.path.join(path, "aot")
    key = _key_for(acc, batch=BATCH, donate=True)
    digest = aot.artifact_digest(aot.artifact_key(key))
    artifact = os.path.join(aot_dir, f"{digest}.pt2")
    blob = open(artifact, "rb").read()
    try:
        with open(artifact, "wb") as f:
            f.write(blob[: len(blob) // 2])
        _load_expect_fallback(aot_dir, key, caplog, "unreadable")
    finally:
        with open(artifact, "wb") as f:
            f.write(blob)


def test_tampered_manifest_falls_back(bundle, caplog):
    """A hand-edited manifest entry no longer matches its own digest: the
    artifact is refused even though the file exists."""
    acc, path = bundle
    aot_dir = os.path.join(path, "aot")
    mpath = os.path.join(aot_dir, aot.MANIFEST)
    saved = open(mpath).read()
    manifest = json.loads(saved)
    key = _key_for(acc, batch=BATCH, donate=True)
    digest = aot.artifact_digest(aot.artifact_key(key))
    try:
        manifest[digest]["opt_level"] = 99
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        _load_expect_fallback(aot_dir, key, caplog, "opt_level")
    finally:
        with open(mpath, "w") as f:
            f.write(saved)


def test_aot_load_fault_takes_warn_and_rebuild_path(bundle, caplog):
    """The fault harness's aot_load site runs inside the artifact read: an
    injected error falls back, and the rebuilt session answers bit for bit
    as the original accelerator."""
    acc, path = bundle
    xs = _requests(BATCH, seed=5)
    y_ref = np.asarray(acc(np.stack(xs)))
    plan = FaultPlan([FaultSpec(site="aot_load", kind="error")])
    prev = aot.set_fault_hook(plan.aot_hook())
    try:
        cache = ProgramCache()
        acc2 = api.Accelerator.from_program(path, params=acc.params,
                                            cache=cache, device="cpu")
        with caplog.at_level(logging.WARNING, logger="repro_torch.aot"):
            with acc2.serve(max_batch=BATCH, buckets=(BATCH,),
                            warmup=True) as s:
                ys = s.run_many([np.stack(xs)])
    finally:
        assert aot.set_fault_hook(prev) is not None
    assert plan.fired("aot_load")                  # the hook really ran
    assert cache.stats.aot_loads == 0              # no artifact served
    assert any(FALLBACK in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(np.asarray(ys[0]), y_ref)


def test_strict_accelerators_refuse_aot(tmp_path):
    acc = api.Accelerator.build(SPECS, target=pm.V5E, batch=BATCH,
                                device="cpu", strict=True)
    with pytest.raises(ValueError, match="strict-interpreter"):
        acc.save_program(str(tmp_path / "b"), aot=True)


# --------------------------------------------------------------------------
# bundles across the two packages
# --------------------------------------------------------------------------

def test_reference_bundle_loads_in_the_port(tmp_path, caplog):
    """The reference's bundle: program.json serves in the port, its XLA
    artifacts read as stale on format and the environment, and the port
    builds fresh."""
    r_acc = r_api.Accelerator.build(R_SPECS, target=r_pm.V5E, batch=BATCH,
                                    seed=0, cache=RProgramCache())
    path = str(tmp_path / "ref_bundle")
    r_acc.save_program(path, aot=True, buckets=(BATCH,))
    params = [tuple(np.asarray(a) for a in p) for p in r_acc.params]
    cache = ProgramCache()
    with caplog.at_level(logging.WARNING, logger="repro_torch.aot"):
        acc = api.Accelerator.from_program(path, params=params, cache=cache,
                                           device="cpu")
        x = np.stack(_requests(BATCH, seed=6))
        y = np.asarray(acc(x))
    assert cache.stats.aot_loads == 0
    text = caplog.text
    assert FALLBACK in text
    for dim in ("format", "device_name", "torch_version"):
        assert dim in text, dim
    np.testing.assert_allclose(y, np.asarray(r_acc(x)), rtol=1e-4,
                               atol=1e-4)


def test_port_bundle_loads_in_the_reference(bundle, caplog):
    """The port's bundle: the reference serves its program.json and falls
    back from its torch.export artifacts with a warning."""
    acc, path = bundle
    params = [tuple(t.numpy() for t in p) for p in acc.params]
    with caplog.at_level(logging.WARNING, logger="repro.aot"):
        r_cache = RProgramCache()
        r_acc = r_api.Accelerator.from_program(path, params=params,
                                               cache=r_cache)
        x = np.stack(_requests(BATCH, seed=7))
        y = np.asarray(r_acc(x))
    assert r_cache.stats.aot_loads == 0 and r_cache.stats.misses == 1
    assert "falling back to fresh compile" in caplog.text
    assert "format" in caplog.text
    np.testing.assert_allclose(y, np.asarray(acc(x)), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# donate_input as a key dimension
# --------------------------------------------------------------------------

def test_donate_input_is_a_key_dimension():
    acc = _build()
    rt = acc.runtime
    plain, params = rt.executor_entry(BATCH, acc.input_dtype)
    donating, params2 = rt.executor_entry(BATCH, acc.input_dtype,
                                          donate_input=True)
    assert plain is not donating and len(params2) == len(params)
    assert not plain.donate_input and donating.donate_input
    assert rt.executor_entry(BATCH, acc.input_dtype,
                             donate_input=True)[0] is donating
    assert _key_for(acc, donate=True) != _key_for(acc)
    assert _key_for(acc, donate=True)[6] is True
    digests = {aot.artifact_digest(aot.artifact_key(_key_for(acc, donate=d)))
               for d in (False, True)}
    assert len(digests) == 2
    # both entries answer the same, and the donating one takes the staged
    # (host) buffer as it is
    x = torch.from_numpy(np.stack(_requests(BATCH, seed=8)))
    np.testing.assert_array_equal(plain(params, x).numpy(),
                                  donating(params, x).numpy())
    assert plain.trace_count == donating.trace_count == 0   # CPU: no graph


def test_every_key_dimension_changes_the_digest():
    acc = _build()
    base = _key_for(acc)
    variants = [base[0][::-1], 4, "int8", ("int8", "int32"), "hopper", 0,
                True, "cuda:0", "deadbeef"]
    cpu_env = aot.environment_fingerprint("cpu")
    digests = {aot.artifact_digest(aot.artifact_key(base))}
    for i, v in enumerate(variants):
        t = list(base)
        t[i] = v
        d = aot.artifact_digest(aot.artifact_key(tuple(t), env=cpu_env))
        assert d not in digests, i
        digests.add(d)
    for dim in ("device_name", "platform", "torch_version", "cuda_version",
                "kernel_digest"):
        env = dict(cpu_env, **{dim: "other"})
        d = aot.artifact_digest(aot.artifact_key(base, env=env))
        assert d not in digests, dim
        digests.add(d)
