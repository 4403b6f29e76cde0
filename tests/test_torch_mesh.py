"""Sharded serving in the port: ``launch/mesh.py``, ``compile_executor`` /
``ProgramCache.get`` / ``HybridRuntime.executor_entry`` with ``mesh=``,
``ServingSession(mesh=)`` and ``Fleet(mesh=)`` — the port's counterparts of
``tests/test_multidevice.py``'s serving cases, on both port backends.

torch has one CPU device, so a mesh here repeats it: four positions on
``cpu`` are four replicas, each running its shard of the batch as an
ordinary single-device entry. That shows the split, the replicated
weights, the gather and the session's bookkeeping, not scaling. One test
runs the reference's sharded session in a subprocess with four forced
host devices (as ``tests/test_multidevice.py`` does) and holds the port's
four-replica session to it.

Tolerances: fp32 within the reference's ``1e-4`` (a shard sums over fewer
rows, so a GEMM may add in another order), int8 bit for bit. Every session
closes in a ``with`` block.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import mesh as r_mesh  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.compat import Mesh, make_mesh  # noqa: E402
from repro_torch.core import executor  # noqa: E402
from repro_torch.core import perf_model as pm  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec, FCSpec  # noqa: E402
from repro_torch.core.hybrid_conv import PoolSpec  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = [ConvSpec("c1", 16, 16, 3, 8), ConvSpec("c2", 16, 16, 8, 16),
         PoolSpec("p1", 16, 16, 16), FCSpec("fc", 8 * 8 * 16, 10, relu=False)]
SPECS_B = [ConvSpec("c1", 16, 16, 3, 12), PoolSpec("p1", 16, 16, 12),
           FCSpec("fc", 8 * 8 * 12, 10, relu=False)]
BACKENDS = ("torch", "hopper")
DTYPES = ("float32", "int8")
TOL = 1e-4


def _mesh(n):
    return make_mesh((n,), ("batch",), devices=["cpu"] * n)


def _build(specs=SPECS, seed=0, **kw):
    return api.Accelerator.build(specs, pm.V5E, batch=8, seed=seed,
                                 device="cpu", cache=ProgramCache(), **kw)


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((16, 16, 3)).astype(np.float32)
            for _ in range(n)]


def _hold(got, ref, dtype):
    d = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(ref, got))
    if dtype == "int8":
        assert d == 0.0, d
    else:
        assert d <= TOL, d


# -- launch/mesh.py ---------------------------------------------------------

def test_launch_meshes_shapes_names_and_range():
    """The port's meshes have the reference's shapes and axis names; the
    fleet mesh refuses an ``n_devices`` outside the local range, and the
    production mesh needs its 256 / 512 devices."""
    host, fleet = t_mesh.make_host_mesh("cpu"), t_mesh.make_fleet_mesh(
        device_type="cpu")
    assert host.shape == dict(r_mesh.make_host_mesh().shape) == \
        {"data": 1, "model": 1}
    assert fleet.shape == dict(r_mesh.make_fleet_mesh().shape) == \
        {"batch": 1}
    assert host.axis_names == ("data", "model")
    assert fleet.axis_names == ("batch",)
    assert list(fleet.devices.flat) == [torch.device("cpu")]
    assert t_mesh.make_fleet_mesh(1, device_type="cpu").size == 1
    for n in (0, 2):
        with pytest.raises(ValueError, match=r"outside \[1, 1\]"):
            t_mesh.make_fleet_mesh(n, device_type="cpu")
        with pytest.raises(ValueError, match=r"outside \[1, 1\]"):
            r_mesh.make_fleet_mesh(n)
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"({n})"):
            t_mesh.make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("a", "b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_mesh.make_host_mesh()


def test_mesh_key_and_count():
    """Shape, axis names and every position's (type, index) join the key:
    a repeated device keys apart from the device once, and an order or a
    name change keys apart too."""
    one, two = _mesh(1), _mesh(2)
    assert executor.mesh_key(None) is None
    assert executor.mesh_device_count(None) == 1
    assert executor.mesh_device_count(two) == 2
    assert executor.mesh_key(two) == ((2,), ("batch",),
                                      (("cpu", None), ("cpu", None)))
    assert executor.mesh_key(one) != executor.mesh_key(two)
    flat = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    assert executor.mesh_key(flat) != executor.mesh_key(two)
    assert executor.mesh_device_count(flat) == 2
    cards = Mesh(np.array([torch.device("cuda", 1), torch.device("cuda", 0)],
                          dtype=object), ("batch",))
    swapped = Mesh(np.array([torch.device("cuda", 0),
                             torch.device("cuda", 1)], dtype=object),
                   ("batch",))
    assert executor.mesh_key(cards) != executor.mesh_key(swapped)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_cache_keying(backend, tmp_path):
    """The mesh joins the program-cache key: sharded and unsharded entries
    of one Program coexist, a one-position mesh aliases the unsharded
    entry, a repeated device keys apart from the device once, a
    non-dividing batch is refused, and an AOT bundle never serves a
    sharded entry (the reference's ``test_sharded_executor_cache_keying``
    and ``program_cache.py:228``)."""
    acc = _build(backend=backend)
    bundle = acc.save_program(str(tmp_path / "b"), aot=True)
    cache, prog = ProgramCache(), acc.program
    kw = dict(batch=8, dtype="float32", backend=backend, device="cpu",
              param_dtypes=tuple(str(w.dtype) for w, _ in
                                 acc.runtime.dram_params()))
    e0 = cache.get(prog, **kw)
    e4 = cache.get(prog, mesh=_mesh(4), **kw)
    e2 = cache.get(prog, mesh=_mesh(2), **kw)
    assert e4 is not e0 and e2 is not e4 and e2 is not e0
    assert cache.get(prog, mesh=_mesh(1), **kw) is e0
    assert cache.get(prog, mesh=t_mesh.make_fleet_mesh(
        device_type="cpu"), **kw) is e0
    assert cache.get(prog, mesh=_mesh(4), **kw) is e4
    assert isinstance(e4, executor.ShardedExecutor)
    assert e4.mesh_key == executor.mesh_key(_mesh(4))
    assert e0.mesh_key is None
    # one position per shard, one single-device entry per distinct device
    assert len(e4.shards) == 4 and len({id(e) for e in e4.shards}) == 1
    assert e4.shards[0].device == "cpu" and not e4.aot_loaded
    with pytest.raises(ValueError, match="divide"):
        cache.get(prog, **dict(kw, batch=6), mesh=_mesh(4))
    aot_dir = os.path.join(bundle, "aot")
    fresh = ProgramCache()
    es = fresh.get(prog, mesh=_mesh(4), aot_dir=aot_dir, **kw)
    assert fresh.stats.aot_loads == 0 and not es.aot_loaded
    assert fresh.get(prog, aot_dir=aot_dir, **kw).aot_loaded
    assert fresh.stats.aot_loads == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_entry_splits_replicates_and_gathers(dtype):
    """``executor_entry(mesh=)``: one weight image per position, shared on
    the runtime's device and made once; the sharded entry's answer is each
    shard's single-device answer, gathered (bit for bit), and equals its
    uncaptured ``fn``; a one-position mesh lowers as no mesh."""
    acc = _build(dtype=dtype)
    rt = acc.runtime
    entry, params = rt.executor_entry(8, acc.input_dtype, mesh=_mesh(4))
    assert len(params) == 4 and all(p is params[0] for p in params)
    assert [w for w, _ in params[0]] == [w for w, _ in rt.dram_params()]
    single, p1 = rt.executor_entry(2, acc.input_dtype)
    x = torch.from_numpy(np.stack(_requests(8, seed=3)))
    if dtype == "int8":
        x = acc.quant.quantize_input(x)
    y = entry(params, x)
    assert y.shape[0] == 8
    ref = torch.cat([single(p1, x[i:i + 2]) for i in range(0, 8, 2)])
    assert torch.equal(y, ref) and torch.equal(entry.fn(params, x), y)
    with pytest.raises(ValueError, match="one weight image per mesh"):
        entry(params[:2], x)
    with pytest.raises(ValueError, match="divide"):
        entry(params, x[:6])
    assert isinstance(executor.compile_executor(
        acc.program, device="cpu", mesh=_mesh(1), quant=acc.quant),
        executor.CompiledExecutor)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_session_parity(backend, dtype):
    """Full buckets split over a four-replica mesh, stragglers too when
    their bucket divides: the results equal the unsharded session's (fp32
    within 1e-4, int8 bit for bit), every batch counts on every position,
    and the rows add up (the reference's
    ``test_sharded_serving_session_parity``). A bucket the mesh does not
    divide takes the single-device entry and counts on position 0."""
    acc = _build(backend=backend, dtype=dtype)
    reqs = _requests(19)                 # 2 full buckets + a straggler
    with acc.serve(max_batch=8, buckets=(4, 8)) as s:
        ref = s.run_many(reqs)
        assert s.stats.device_batches == {0: 3}
    with acc.serve(max_batch=8, buckets=(4, 8), mesh=_mesh(4)) as s:
        got = s.run_many(reqs)
        st = s.stats
        assert sorted(s._sharded_entries) == [4, 8]
    _hold(got, ref, dtype)
    assert len(st.device_batches) == 4
    assert st.device_batches == {0: 3, 1: 3, 2: 3, 3: 3}
    assert st.dispatched_rows == 19 and st.padded_rows == 1
    assert st.submitted == st.requests == 19 and st.errors == 0
    assert st.compile_ms >= 0.0 and st.warm_load_ms == 0.0
    with acc.serve(max_batch=8, buckets=(3, 8), mesh=_mesh(4)) as s:
        got = s.run_many(reqs)
        assert sorted(s._sharded_entries) == [8]
        assert s.stats.device_batches == {0: 3, 1: 2, 2: 2, 3: 2}
    _hold(got, ref, dtype)


def test_hopper_matches_torch_under_mesh():
    """``backend="hopper"`` serves sharded (its kernels' plain versions
    here) within 1e-4 of the torch lowering under the same mesh."""
    acc_t = _build()
    acc_h = _build(backend="hopper", params=acc_t.params)
    reqs = _requests(8)
    with acc_t.serve(max_batch=8, buckets=(8,), mesh=_mesh(4)) as s:
        ref = s.run_many(reqs)
    with acc_h.serve(max_batch=8, buckets=(8,), mesh=_mesh(4)) as s:
        got = s.run_many(reqs)
    _hold(got, ref, "float32")


@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_multi_model_bitwise_under_mesh(backend):
    """Two models co-tenanting one Fleet over one mesh give bit for bit
    their standalone sharded sessions' results (the reference's
    ``test_fleet_multi_model_bitwise_stable``); ``mesh="host"`` on the
    CPU is one position and serves unsharded."""
    acc_a = _build(backend=backend)
    acc_b = _build(SPECS_B, seed=1, backend=backend, dtype="int8")
    mesh, reqs = _mesh(4), _requests(8)
    with acc_a.serve(max_batch=8, buckets=(8,), mesh=mesh) as s:
        ref_a = s.run_many(reqs)
    with acc_b.serve(max_batch=8, buckets=(8,), mesh=mesh) as s:
        ref_b = s.run_many(reqs)
    with api.Fleet({"a": acc_a, "b": acc_b}, mesh=mesh, max_batch=8,
                   buckets=(8,)) as fleet:
        assert fleet.mesh is mesh
        res = fleet.run_many([("a", r) for r in reqs]
                             + [("b", r) for r in reqs])
        assert all(len(st.device_batches) == 4
                   for st in fleet.stats().values())
    for got, ref in zip(res, ref_a + ref_b):
        np.testing.assert_array_equal(got, ref)
    with api.Fleet({"a": acc_a}, mesh="host", max_batch=8,
                   buckets=(8,)) as fleet:
        assert fleet.mesh.size == 1
        np.testing.assert_array_equal(
            np.stack(fleet.run_many([("a", r) for r in reqs])),
            acc_a(np.stack(reqs)).numpy())


def test_mesh_refusals():
    """The reference's two refusals: segmented and strict accelerators
    cannot shard, and a mesh that divides no bucket never engages."""
    acc = _build()
    with pytest.raises(ValueError, match="divides evenly"):
        acc.serve(max_batch=8, buckets=(3, 8), mesh=_mesh(5))
    strict = _build(strict=True)
    with pytest.raises(ValueError, match="segmented/strict"):
        strict.serve(max_batch=8, buckets=(8,), mesh=_mesh(2))
    with strict.serve(max_batch=8, buckets=(8,), mesh=_mesh(1)) as s:
        assert len(s.run_many(_requests(2))) == 2
    with pytest.raises(TypeError, match="mesh must be"):
        acc.serve(max_batch=8, mesh=4)


def test_sharded_session_bisects_on_its_backend():
    """A failed sharded batch is bisected at the same bucket, through the
    same sharded entry: innocents bit for bit the fault-free run, the
    offender isolated, no batch degraded."""
    from repro_torch.serving import FaultPlan, FaultSpec
    acc = _build(backend="hopper")
    reqs = _requests(16, seed=4)
    with acc.serve(max_batch=8, buckets=(8,), mesh=_mesh(2)) as s:
        ref = s.run_many(reqs)
    plan = FaultPlan([FaultSpec(site="execute", kind="error", at=(1,),
                                match=(("backend", "hopper"),))])
    with acc.serve(max_batch=8, buckets=(8,), mesh=_mesh(2),
                   fault_plan=plan) as s:
        got = s.run_many(reqs)
        st = s.stats
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(plan.fired()) == 1 and st.retries == 2
    assert st.degraded == 0 and st.errors == 0
    assert st.device_batches == {0: 2, 1: 2}


def test_sharded_session_submit_path():
    """Single images through ``submit`` coalesce into sharded batches and
    each future resolves to its own row."""
    acc = _build(dtype="int8")
    reqs = _requests(12, seed=5)
    ref = [acc(r[None]).numpy()[0] for r in reqs]
    with acc.serve(max_batch=4, buckets=(4,), mesh=_mesh(2),
                   warmup=True) as s:
        futs = s.submit_many(reqs)
        out = [f.result(timeout=60) for f in futs]
        st = s.stats
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert sum(st.device_batches.values()) == 2 * st.batches
    assert st.submitted == st.requests == 12


def test_serve_cli_mesh(capsys):
    """``--mesh`` of the serve CLI: ``host`` (the default) and ``none``
    both serve the session, and the per-device line names the mesh."""
    from repro_torch.launch.serve import serve_cnn
    for mesh in ("host", "none"):
        serve_cnn("vgg16", batch=2, iters=1, device="cpu", session=True,
                  mesh=mesh)
        out = capsys.readouterr().out
        assert f"per-device batches (mesh={mesh}): {{0: 1}}" in out
    with pytest.raises(ValueError, match="--mesh"):
        serve_cnn("vgg16", batch=2, iters=1, device="cpu", mesh="fleet")


_REFERENCE = """
import json, sys
import numpy as np
from repro import api
from repro.core import perf_model as pm
from repro.core.hybrid_conv import ConvSpec, FCSpec, PoolSpec
from repro.launch.mesh import make_fleet_mesh
SPECS = [ConvSpec("c1", 16, 16, 3, 8), ConvSpec("c2", 16, 16, 8, 16),
         PoolSpec("p1", 16, 16, 16), FCSpec("fc", 8 * 8 * 16, 10, relu=False)]
out = sys.argv[1]
acc = api.Accelerator.build(SPECS, target=pm.V5E, batch=8, seed=0)
mesh = make_fleet_mesh(4)
reqs = list(np.load(out + "/reqs.npy"))
with acc.serve(max_batch=8, buckets=(4, 8), mesh=mesh) as s:
    got = np.stack([np.asarray(o) for o in s.run_many(reqs)])
    st = s.stats
np.save(out + "/ref.npy", got)
np.savez(out + "/params.npz", *[np.asarray(a) for p in acc.params for a in p])
json.dump({"device_batches": {str(k): v for k, v in
                              st.device_batches.items()},
           "dispatched_rows": st.dispatched_rows,
           "padded_rows": st.padded_rows}, open(out + "/stats.json", "w"))
"""


def test_port_sharded_session_matches_reference_subprocess(tmp_path):
    """The reference's sharded session over ``make_fleet_mesh(4)`` (four
    forced host devices, in a subprocess) and the port's over four
    replicas, on the same params and requests: fp32 within 1e-4, and the
    same batches per device, rows and padding."""
    reqs = np.stack(_requests(19, seed=7))
    np.save(tmp_path / "reqs.npy", reqs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(_REPO, "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        str(tmp_path)], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with np.load(tmp_path / "params.npz") as z:
        flat = [z[f"arr_{i}"] for i in range(len(z.files))]
    params = api.params_from_numpy(list(zip(flat[::2], flat[1::2])), "cpu")
    acc = _build(params=params)
    with acc.serve(max_batch=8, buckets=(4, 8), mesh=_mesh(4)) as s:
        got = np.stack(s.run_many(list(reqs)))
        st = s.stats
    ref = np.load(tmp_path / "ref.npy")
    assert float(np.abs(got - ref).max()) <= TOL
    stats = json.load(open(tmp_path / "stats.json"))
    assert sorted(stats["device_batches"].values()) == \
        sorted(st.device_batches.values())
    assert stats["dispatched_rows"] == st.dispatched_rows == 19
    assert stats["padded_rows"] == st.padded_rows
