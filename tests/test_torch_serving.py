"""The port's ``ServingSession`` and ``Fleet`` against the reference's
(ports of ``tests/test_serving_scheduler.py`` and the session cases of
``tests/test_api.py``), on both port backends on the CPU.

Three properties over request traces, as in the reference:

* **routing** — every request's result is the accelerator's output for
  THAT request, whatever batch it was coalesced into;
* **no starvation** — every submitted request completes, including a lone
  straggler co-tenanting with a model that keeps the shared slot pool busy;
* **exact accounting** — ``dispatched_rows`` equals the rows submitted,
  ``padded_rows`` the bucket slack, ``device_batches`` sums to
  ``batches``.

On the deterministic bulk path (``run_many``) the port's accounting,
padding and bucket routing equal the reference session's, and its results
are within the reference's fp32 budget ``rtol=atol=1e-4``
(``tests/test_backend_pallas.py``) of the reference session's, int8 bit
for bit (the port serves the reference's saved int8 program: the same
sidecar). Host int8 staging equals ``QuantSidecar.quantize_input`` bit for
bit. Every wait takes a timeout and every session closes in a ``with``
block or a ``finally``.
"""
import concurrent.futures
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as r_api  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.core.hybrid_conv import ConvSpec as RConvSpec  # noqa: E402
from repro.core.hybrid_conv import FCSpec as RFCSpec  # noqa: E402
from repro.core.hybrid_conv import PoolSpec as RPoolSpec  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import perf_model as pm  # noqa: E402
from repro_torch.core.compiler import LayerPlan  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec, FCSpec  # noqa: E402
from repro_torch.core.hybrid_conv import PoolSpec  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:       # optional dev dep; seeded cases still run
    HAVE_HYPOTHESIS = False

SPECS = [ConvSpec("c1", 16, 16, 3, 8), ConvSpec("c2", 16, 16, 8, 16),
         PoolSpec("p1", 16, 16, 16), FCSpec("fc", 8 * 8 * 16, 10, relu=False)]
R_SPECS = [RConvSpec("c1", 16, 16, 3, 8), RConvSpec("c2", 16, 16, 8, 16),
           RPoolSpec("p1", 16, 16, 16),
           RFCSpec("fc", 8 * 8 * 16, 10, relu=False)]
MAX_BATCH = 4
BUCKETS = (2, 4)
BACKENDS = ("torch", "hopper")
TOL = dict(rtol=1e-4, atol=1e-4)
_DEADLINE_S = 60.0


def _build(backend, seed=0, **kw):
    return api.Accelerator.build(SPECS, pm.V5E, batch=MAX_BATCH, seed=seed,
                                 backend=backend, device="cpu",
                                 cache=ProgramCache(), **kw)


@pytest.fixture(scope="module", params=BACKENDS)
def acc(request):
    return _build(request.param)


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((16, 16, 3)).astype(np.float32)
            for _ in range(n)]


def _reference(acc, reqs):
    """Per-request reference outputs via the direct accelerator."""
    y = acc(np.stack(reqs)).numpy()
    return [y[i] for i in range(len(reqs))]


def _check_routing(results, refs):
    """Each result matches ITS request's reference — distinct gaussian
    inputs give outputs ~1e-2 apart, so atol=1e-4 catches any row swap."""
    for got, ref in zip(results, refs):
        np.testing.assert_allclose(np.asarray(got), ref, atol=1e-4)


def _check_accounting(stats, total_rows):
    assert stats.dispatched_rows == total_rows
    assert stats.requests == total_rows       # single-image requests
    assert stats.padded_rows >= 0
    staged = stats.dispatched_rows + stats.padded_rows
    assert (stats.batches * min(BUCKETS) <= staged
            <= stats.batches * max(BUCKETS))
    assert sum(stats.device_batches.values()) == stats.batches
    assert stats.occupancy() == pytest.approx(
        stats.dispatched_rows / staged)
    assert stats.wait_p50_ms() >= 0.0
    assert stats.wait_p95_ms() >= stats.wait_p50_ms()
    assert stats.submitted == stats.requests + stats.errors + stats.shed


def _retry_timing_flake(test_fn):
    """Retry ONCE with a wider deadline before declaring a timing red (a
    loaded host can stall a drain thread past the window); a genuine
    routing or accounting bug fails twice and stays red."""
    @functools.wraps(test_fn)
    def wrapper(*args, **kwargs):
        global _DEADLINE_S
        try:
            return test_fn(*args, **kwargs)
        except (AssertionError, TimeoutError,
                concurrent.futures.TimeoutError):
            _DEADLINE_S = 240.0
            try:
                return test_fn(*args, **kwargs)
            finally:
                _DEADLINE_S = 60.0
    return wrapper


def _run_trace(acc, trace, scheduler, seed=1):
    """Submit a (burst_size, gap_ms) trace; return (results, refs, stats)."""
    n = sum(b for b, _ in trace)
    reqs = _requests(n, seed)
    refs = _reference(acc, reqs)
    futs, i = [], 0
    with acc.serve(max_batch=MAX_BATCH, buckets=BUCKETS, max_wait_ms=2.0,
                   scheduler=scheduler) as s:
        for burst, gap_ms in trace:
            futs += s.submit_many(reqs[i:i + burst])
            i += burst
            if gap_ms:
                time.sleep(gap_ms / 1e3)
        results = [f.result(timeout=_DEADLINE_S) for f in futs]
        stats = s.stats
    return results, refs, stats


# -- the scheduler (tests/test_serving_scheduler.py) ---------------------------

@pytest.mark.parametrize("scheduler", api.ServingSession.SCHEDULERS)
@_retry_timing_flake
def test_bursty_trace_routing_and_accounting(acc, scheduler):
    trace = [(3, 1.0), (1, 0.0), (4, 2.0), (2, 1.0), (1, 3.0), (4, 0.0),
             (2, 0.0)]
    results, refs, stats = _run_trace(acc, trace, scheduler)
    _check_routing(results, refs)
    _check_accounting(stats, sum(b for b, _ in trace))


def test_deterministic_bulk_padding_equals_the_reference(acc):
    """A deep backlog groups deterministically — one full 4-batch, then 3
    rows padded into the 4-bucket — with the reference session's exact
    counters, and results within 1e-4 of the reference session's."""
    reqs = _requests(7)
    refs = _reference(acc, reqs)
    with acc.serve(max_batch=MAX_BATCH, buckets=BUCKETS) as s:
        results = s.run_many(reqs)
        stats = s.stats
    _check_routing(results, refs)
    assert stats.batches == 2
    assert stats.dispatched_rows == 7
    assert stats.padded_rows == 1
    assert stats.occupancy() == pytest.approx(7 / 8)
    assert sum(stats.device_batches.values()) == 2

    r_acc = r_api.Accelerator.build(R_SPECS, r_pm.V5E, batch=MAX_BATCH,
                                    seed=0)
    with r_acc.serve(max_batch=MAX_BATCH, buckets=BUCKETS) as s:
        r_results = s.run_many(reqs)
        r_stats = s.stats
    for name in ("batches", "dispatched_rows", "padded_rows", "submitted",
                 "requests", "errors", "shed", "retries", "isolated",
                 "degraded"):
        assert getattr(stats, name) == getattr(r_stats, name), name
    assert stats.device_batches == r_stats.device_batches
    for got, ref in zip(results, r_results):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_int8_session_equals_the_reference_session_bit_for_bit(backend,
                                                               tmp_path):
    """The reference's int8 program (saved, loaded in the port: the same
    sidecar and weights) served through both packages' sessions: bulk
    and coalesced results bit for bit, equal counters."""
    params = [(np.asarray(w), np.asarray(b))
              for w, b in r_api.random_params(R_SPECS, seed=0)]
    calib = np.random.default_rng(2).standard_normal(
        (8, 16, 16, 3)).astype(np.float32)
    r_acc = r_api.Accelerator.build(R_SPECS, r_pm.V5E, batch=MAX_BATCH,
                                    params=params, dtype="int8", calib=calib)
    path = r_acc.save_program(str(tmp_path / "int8.json"))
    t_acc = api.Accelerator.from_program(path, params=params,
                                         backend=backend, device="cpu",
                                         cache=ProgramCache())
    reqs = _requests(7, seed=9)
    outs, stats = {}, {}
    for name, a in (("ref", r_acc), ("port", t_acc)):
        with a.serve(max_batch=MAX_BATCH, buckets=BUCKETS) as s:
            outs[name] = [np.asarray(y) for y in s.run_many(reqs)]
            stats[name] = (s.stats.batches, s.stats.padded_rows,
                           s.stats.dispatched_rows, s.stats.requests)
    assert stats["port"] == stats["ref"] == (2, 1, 7, 7)
    for a, b in zip(outs["port"], outs["ref"]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # the full bucket is the direct call's entry: bit for bit with acc(x)
    np.testing.assert_array_equal(np.stack(outs["port"][:4]),
                                  t_acc(np.stack(reqs[:4])).numpy())


def test_int8_host_staging_equals_quantize_input():
    """The session quantizes on the host with the reference's numpy
    arithmetic; it equals the device-side ``quantize_input`` bit for bit,
    ties (round half to even) and the clip included."""
    acc = _build("torch", dtype="int8")
    scale = np.float32(acc.quant.input_scale)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32) * 3
    # exact ties k + 1/2 in units of the scale, and values past the clip
    ties = (np.arange(-40, 40, dtype=np.float32) + np.float32(0.5)) * scale
    x.reshape(-1)[:ties.size] = ties
    x.reshape(-1)[-4:] = np.float32([1e3, -1e3, 200, -200]) * scale
    with acc.serve(max_batch=MAX_BATCH, buckets=BUCKETS) as s:
        staged, single = s._stage(x)
    assert not single and staged.dtype == np.int8
    ref = acc.quant.quantize_input(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(staged, ref)
    assert set(np.abs(staged.reshape(-1)[-4:]).tolist()) == {127}


@_retry_timing_flake
def test_mixed_submit_paths_route_correctly(acc):
    """submit / submit_many / run_many interleaved from the caller thread
    all resolve to their own rows (the inline bulk path and the worker
    share the slot pool but never each other's staging)."""
    reqs = _requests(10, seed=3)
    refs = _reference(acc, reqs)
    with acc.serve(max_batch=MAX_BATCH, buckets=BUCKETS) as s:
        f0 = s.submit(reqs[0])
        bulk = s.run_many(reqs[1:6])
        fs = s.submit_many(reqs[6:])
        results = [f0.result(timeout=_DEADLINE_S)] + list(bulk) + [
            f.result(timeout=_DEADLINE_S) for f in fs]
        stats = s.stats
    _check_routing(results, refs)
    _check_accounting(stats, 10)


@_retry_timing_flake
def test_no_starvation_under_co_tenant_flood(acc):
    """A lone request on model B completes while model A floods the shared
    pool — the continuous admitter's hard cap forces B's straggler out."""
    acc_b = _build(acc.backend, seed=7)
    reqs = _requests(40, seed=4)
    lone = _requests(1, seed=5)[0]
    lone_ref = _reference(acc_b, [lone])[0]
    with api.Fleet({"a": acc, "b": acc_b}, max_batch=MAX_BATCH,
                   buckets=BUCKETS, max_wait_ms=2.0) as fleet:
        flood = [fleet.submit("a", r) for r in reqs]
        lone_fut = fleet.submit("b", lone)
        got = lone_fut.result(timeout=_DEADLINE_S)   # must not starve
        for f in flood:
            f.result(timeout=_DEADLINE_S)
    np.testing.assert_allclose(np.asarray(got), lone_ref, atol=1e-4)


def test_scheduler_validation(acc):
    with pytest.raises(ValueError, match="scheduler"):
        acc.serve(scheduler="adaptive")
    with pytest.raises(ValueError, match="capacity"):
        api._SlotPool(0)
    with pytest.raises(ValueError, match="cover max_batch"):
        acc.serve(max_batch=4, buckets=(1, 2))


def test_fleet_validation(acc):
    with pytest.raises(ValueError, match="at least one"):
        api.Fleet({})
    with api.Fleet({"m": acc}, max_batch=MAX_BATCH, buckets=BUCKETS) as f:
        with pytest.raises(ValueError, match="unknown model"):
            f.submit("nope", _requests(1)[0])
        assert f.models == ("m",)
        assert set(f.stats()) == {"m"}


def test_fleet_round_robin_accounting(acc):
    """Two tenants, interleaved requests: per-model stats stay exact and
    per-model outputs match each model's own reference."""
    acc_b = _build(acc.backend, seed=11)
    reqs_a, reqs_b = _requests(9, seed=6), _requests(5, seed=8)
    refs_a, refs_b = _reference(acc, reqs_a), _reference(acc_b, reqs_b)
    with api.Fleet({"a": acc, "b": acc_b}, max_batch=MAX_BATCH,
                   buckets=BUCKETS) as fleet:
        pairs = [("a", r) for r in reqs_a] + [("b", r) for r in reqs_b]
        results = fleet.run_many(pairs)
        st_a, st_b = fleet.stats()["a"], fleet.stats()["b"]
    _check_routing(results[:9], refs_a)
    _check_routing(results[9:], refs_b)
    assert st_a.dispatched_rows == 9
    assert st_b.dispatched_rows == 5
    assert sum(st_a.device_batches.values()) == st_a.batches
    assert sum(st_b.device_batches.values()) == st_b.batches


def test_concurrent_clients_stress_routing_and_accounting(acc):
    """More client threads than cores submit and bulk-run at once, with a
    short switch interval: every future resolves to its own row and the
    counters (bumped from every thread) balance to the request. Several
    concurrent ``run_many`` callers deadlock the reference (each holds a
    slot and waits for one more); the port's bulk path never waits for a
    slot while it holds one."""
    import os
    import sys
    import threading

    n_threads, per_thread = 2 * (os.cpu_count() or 2) + 2, 6
    reqs = _requests(n_threads * per_thread, seed=12)
    refs = _reference(acc, reqs)
    results: dict[int, np.ndarray] = {}
    errors: list[BaseException] = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with acc.serve(max_batch=MAX_BATCH, buckets=BUCKETS,
                       max_wait_ms=1.0) as s:
            def client(t):
                try:
                    ids = range(t * per_thread, (t + 1) * per_thread)
                    if t % 3 == 0:
                        outs = s.run_many([reqs[i] for i in ids])
                    else:
                        futs = [s.submit(reqs[i]) for i in ids]
                        outs = [f.result(timeout=_DEADLINE_S) for f in futs]
                    results.update(zip(ids, outs))
                except BaseException as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(t,),
                                        daemon=True)
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=2 * _DEADLINE_S)
            assert not any(t.is_alive() for t in threads)
            stats = s.stats
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    _check_routing([results[i] for i in range(len(reqs))], refs)
    _check_accounting(stats, len(reqs))


# -- the session surface (tests/test_api.py) -----------------------------------

def _spat_acc(backend):
    return api.Accelerator.build(
        SPECS, plans=[LayerPlan("spat", "is"), LayerPlan("spat", "is"),
                      None, None], seed=0, backend=backend, device="cpu",
        cache=ProgramCache())


@pytest.mark.parametrize("backend", BACKENDS)
def test_serving_session_batches_and_preserves_order(backend):
    acc = _spat_acc(backend)
    x = np.random.default_rng(3).standard_normal(
        (6, 16, 16, 3)).astype(np.float32)
    y_ref = acc(x).numpy()
    with acc.serve(max_batch=4, warmup=True) as s:
        # a full-bucket request runs through the SAME cached executor entry
        # as the direct call -> bit for bit
        np.testing.assert_array_equal(np.asarray(s(x[:4])),
                                      acc(x[:4]).numpy())
        futs = [s.submit(x[0]), s.submit(x[1:4]), s.submit(x[4]),
                s.submit(x[5])]
        outs = [np.asarray(f.result(timeout=_DEADLINE_S)) for f in futs]
        assert s.stats.compile_ms > 0.0          # warmup: every bucket
    np.testing.assert_allclose(outs[0], y_ref[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(outs[1], y_ref[1:4], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(outs[2], y_ref[4], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(outs[3], y_ref[5], atol=1e-5, rtol=1e-5)
    assert s.stats.requests == 5
    assert s.stats.batches >= 3


def test_serving_session_rejects_oversized_and_closed():
    acc = _spat_acc("torch")
    s = acc.serve(max_batch=2)
    try:
        with pytest.raises(ValueError, match="max_batch"):
            s.submit(np.zeros((3, 16, 16, 3), np.float32))
        with pytest.raises(ValueError, match="max_batch"):
            s.submit(np.empty((0, 16, 16, 3), np.float32))
        with pytest.raises(ValueError, match="rank"):
            s.submit(np.zeros((16, 16)))
        with pytest.raises(ValueError, match="input shape"):
            s.submit(np.zeros((17, 16, 3)))
    finally:
        s.close()
    s.close()                                      # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(np.zeros((1, 16, 16, 3), np.float32))


def test_mesh_on_one_device_serves_and_more_devices_refuse(acc):
    x = _requests(2)
    with acc.serve(max_batch=2, buckets=(2,), mesh="host") as s:
        out = s.run_many(x)
        assert s.stats.device_batches == {0: 1}
    np.testing.assert_array_equal(np.stack(out), acc(np.stack(x)).numpy())
    # more positions serve sharded (tests/test_torch_mesh.py), but a mesh
    # that divides no bucket is refused, by the session and by a Fleet
    with pytest.raises(ValueError, match="divides evenly"):
        acc.serve(max_batch=2, buckets=(2,), mesh=["cpu"] * 3)
    with pytest.raises(ValueError, match="divides evenly"):
        api.Fleet({"m": acc}, max_batch=2, buckets=(2,), mesh=["cpu"] * 3)


def test_serve_cli_session_prints_the_ledger(capsys):
    from repro_torch.launch.serve import serve_cnn
    serve_cnn("resnet18", batch=2, iters=2, backend="hopper", dtype="int8",
              device="cpu", session=True, scheduler="bucketed",
              deadline_ms=60_000.0, queue_limit=64)
    out = capsys.readouterr().out
    assert "ServingSession[bucketed]: 4 requests" in out
    assert ("failure model: submitted 4 = completed 4 + errors 0 + shed 0"
            in out)
    assert "degraded 0" in out


# -- randomized arrivals (hypothesis) ------------------------------------------

if HAVE_HYPOTHESIS:
    _HYP_ACC = {}

    @settings(max_examples=6, deadline=None)
    @given(
        trace=st.lists(
            st.tuples(st.integers(1, MAX_BATCH), st.sampled_from(
                [0.0, 0.5, 1.5, 3.0])),
            min_size=1, max_size=8),
        scheduler=st.sampled_from(api.ServingSession.SCHEDULERS),
        backend=st.sampled_from(BACKENDS),
        seed=st.integers(0, 2 ** 16),
    )
    def test_random_arrivals_route_and_balance(trace, scheduler, backend,
                                               seed):
        if backend not in _HYP_ACC:
            _HYP_ACC[backend] = _build(backend)
        results, refs, stats = _run_trace(_HYP_ACC[backend], trace,
                                          scheduler, seed=seed)
        _check_routing(results, refs)
        _check_accounting(stats, sum(b for b, _ in trace))


# -- the session trace and the settled heap ------------------------------------

def test_session_trace_accounts_for_every_request(acc):
    """``serving.trace.run_window`` wraps a session's own methods: every
    request lands in a traced batch, its latency splits into the parts
    the trace names, and the CPU records no device time."""
    from repro_torch.serving.trace import run_window
    images = np.stack(_requests(8, seed=5))
    s = run_window(acc, images, 2000.0, 40, clients=2, max_batch=MAX_BATCH)
    assert s["requests"] == 40 and 10 <= s["batches"] <= 40
    assert s["latency_p50_ms"] <= s["latency_p95_ms"] <= s["latency_max_ms"]
    assert s["device_busy_share"] is None and s["device_ms_by_bucket"] == {}
    assert s["tail_requests"] >= 2
    assert set(s["tail_parts_ms"]) == {"queue_ms", "slot_ms", "launch_ms",
                                       "launch_to_drained_ms", "deliver_ms"}
    assert sum(b["requests"] for b in s["tail_bursts"]) <= s["tail_requests"]
    assert s["served_images_per_s"] > 0 and s["clients"] == 2


def test_settled_heap_freezes_only_inside_the_block():
    import gc
    with api.settled_heap():
        assert gc.get_freeze_count() > 0
    assert gc.get_freeze_count() == 0
