"""The port's fault-tolerant serving tier (a port of
``tests/test_fault_injection.py``), on both port backends on the CPU:
deterministic fault injection (``repro_torch.serving.faults``), deadlines,
bounded admission, poisoned-batch isolation and thread supervision. The
reference's ``pallas`` -> ``xla`` degradation is not ported: a failed
``hopper`` batch is bisected on ``hopper`` and never re-run on the ``torch``
lowering.

The load-bearing property is the **liveness invariant**: under every
seeded :class:`FaultPlan` — including plans that kill a pipeline thread —
every submitted request's future resolves (result or typed error) and the
session counters balance exactly::

    stats.submitted == stats.requests + stats.errors + stats.shed

Isolation is held bit for bit: when one poisoned request fails a batch,
every innocent co-batched request returns the same bits as a fault-free
run. The two packages' ``FaultPlan``s fire on the same visits for the same
seed. The reference's ``aot_load`` case is driven in
``tests/test_torch_aot.py``
(``test_aot_load_fault_takes_warn_and_rebuild_path``). Every wait takes a
timeout and every session closes in a ``with`` block or a ``finally``.
"""
import dataclasses
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import FaultPlan as RFaultPlan  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import HeartbeatMonitor  # noqa: E402
from repro_torch.core import perf_model as pm  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec, FCSpec  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.kernels.gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.spatial_conv import ops as conv_ops  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SITES,
    DeadlineExceeded,
    DeadlineTable,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    NumericsError,
    Overloaded,
    PipelineCrashed,
    ThreadKilled,
    ThreadSupervisor,
    chaos_soak,
)

SPECS = [ConvSpec("c1", 16, 16, 3, 8), FCSpec("fc", 16 * 16 * 8, 10,
                                              relu=False)]


def _build(backend):
    return api.Accelerator.build(SPECS, pm.V5E, batch=4, seed=0,
                                 backend=backend, device="cpu",
                                 cache=ProgramCache())


@pytest.fixture(scope="module", params=["torch", "hopper"])
def acc(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def acc_hopper():
    return _build("hopper")


def _x(seed=0, n=1):
    xs = np.random.default_rng(seed).standard_normal(
        (n, 16, 16, 3)).astype(np.float32)
    return xs[0] if n == 1 else xs


def _balanced(st):
    return st.submitted == st.requests + st.errors + st.shed


# -- the FaultPlan itself ----------------------------------------------------

def test_fault_plan_is_deterministic_and_validated():
    a = FaultPlan.seeded(7, n_faults=12, n_requests=32)
    b = FaultPlan.seeded(7, n_faults=12, n_requests=32)
    assert a.specs == b.specs                       # byte-identical schedule
    assert a.specs != FaultPlan.seeded(8, n_faults=12, n_requests=32).specs
    for s in a.specs:                               # corruption needs payload
        if s.kind in ("nan", "inf"):
            assert s.site in ("staging", "execute")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec(site="warp-core")
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(site="dispatch", kind="gamma-ray")
    assert "aot_load" in SITES                      # kept for item 9


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plans_fire_on_the_same_visits_as_the_reference(seed):
    """One seed, one schedule in both packages, and one fired log over the
    same sequence of visits."""
    kw = dict(n_faults=10, horizon=16, n_requests=12,
              kinds=("error", "delay", "nan", "kill"), max_delay_ms=1.0)
    t_plan, r_plan = FaultPlan.seeded(seed, **kw), RFaultPlan.seeded(seed,
                                                                      **kw)
    assert ([dataclasses.astuple(s) for s in t_plan.specs]
            == [dataclasses.astuple(s) for s in r_plan.specs])
    rng = np.random.default_rng(seed)
    for _ in range(64):
        site = ("dispatch", "execute", "drain")[int(rng.integers(3))]
        rids = sorted({int(r) for r in rng.integers(12, size=2)})
        outcomes = []
        for plan in (t_plan, r_plan):
            payload = np.ones((4, 2), np.float32)
            try:
                plan.visit(site, payload=payload, requests=rids,
                           rows={r: (i * 2, 2) for i, r in enumerate(rids)},
                           backend="torch")
                outcomes.append(("ok", payload.tobytes()))
            except BaseException as e:  # noqa: BLE001 — kills included
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1]
    assert t_plan.fired() == r_plan.fired()
    assert t_plan.counts() == r_plan.counts()
    assert t_plan.fired()                     # the schedule really fired


def test_fault_plan_matching_ordinals_requests_and_ctx():
    plan = FaultPlan([
        FaultSpec(site="dispatch", kind="error", at=(1,), message="ordinal"),
        FaultSpec(site="execute", kind="error", requests=(5,),
                  message="cursed"),
        FaultSpec(site="execute", kind="error",
                  match=(("backend", "hopper"),), message="ctx"),
    ])
    plan.visit("dispatch")                          # ordinal 0: no match
    with pytest.raises(InjectedFault, match="ordinal"):
        plan.visit("dispatch")                      # ordinal 1 fires
    plan.visit("execute", requests=[1, 2], backend="torch")  # innocent
    with pytest.raises(InjectedFault, match="cursed"):
        plan.visit("execute", requests=[4, 5], backend="torch")
    with pytest.raises(InjectedFault, match="ctx"):
        plan.visit("execute", requests=[9], backend="hopper")
    assert plan.counts()["dispatch"] == 2 and plan.counts()["execute"] == 3
    assert [e["message"] for e in plan.fired()] == ["ordinal", "cursed",
                                                    "ctx"]


def test_fault_plan_corruption_scoped_and_int_safe():
    plan = FaultPlan([FaultSpec(site="execute", kind="nan", requests=(3,))])
    buf = np.ones((4, 2), np.float32)
    plan.visit("execute", payload=buf, requests=[2, 3],
               rows={2: (0, 2), 3: (2, 2)})
    assert np.isfinite(buf[:2]).all()               # innocent rows untouched
    assert np.isnan(buf[2:]).all()                  # cursed rows poisoned
    ibuf = np.ones((4, 2), np.int8)                 # int8 has no NaN: no-op
    plan.visit("execute", payload=ibuf, requests=[3], rows={3: (2, 2)})
    assert (ibuf == 1).all()


def test_fault_plan_kill_is_base_exception():
    assert not issubclass(ThreadKilled, Exception)
    with pytest.raises(BaseException):
        FaultPlan([FaultSpec(site="drain", kind="kill")]).visit("drain")


# -- liveness under seeded chaos ---------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_soak_liveness_and_exact_accounting(acc, seed):
    plan = FaultPlan.seeded(seed, n_faults=6, horizon=12, n_requests=24)
    report = chaos_soak(acc, plan=plan, n_requests=24, timeout_s=90.0,
                        raise_on_failure=True)
    assert report["unresolved"] == 0 and report["balanced"]


@pytest.mark.parametrize("site", ["dispatch", "drain"])
def test_chaos_soak_survives_a_killed_pipeline_thread(acc, site):
    plan = FaultPlan([FaultSpec(site=site, kind="kill",
                                at=(2,) if site == "dispatch" else (1,))])
    report = chaos_soak(acc, plan=plan, n_requests=12, timeout_s=90.0,
                        raise_on_failure=True, max_batch=2, buckets=(2,))
    assert report["watchdog_restarts"] >= 1


def test_watchdog_restart_fails_inflight_with_causal_exception(acc):
    plan = FaultPlan([FaultSpec(site="dispatch", kind="kill", at=(1,))])
    with acc.serve(max_batch=2, buckets=(2,), max_wait_ms=1.0, warmup=True,
                   fault_plan=plan) as s:
        assert s.submit(_x()).result(timeout=60) is not None
        doomed = s.submit(_x())
        with pytest.raises(PipelineCrashed) as ei:
            doomed.result(timeout=60)
        assert isinstance(ei.value.__cause__, ThreadKilled)   # causal chain
        # the restarted pipeline serves new traffic
        assert s.submit(_x()).result(timeout=60) is not None
        st = s.stats
        assert st.watchdog_restarts >= 1 and _balanced(st)


# -- poisoned-batch isolation ------------------------------------------------

def test_innocent_requests_bitwise_identical_after_isolation(acc):
    xs = _x(seed=3, n=4)
    with acc.serve(max_batch=4, buckets=(4,), max_wait_ms=20.0,
                   warmup=True) as s:
        ref = [np.asarray(f.result(timeout=60))
               for f in s.submit_many(xs)]
    plan = FaultPlan([FaultSpec(site="execute", kind="error", requests=(2,),
                                message="cursed")])
    with acc.serve(max_batch=4, buckets=(4,), max_wait_ms=20.0, warmup=True,
                   fault_plan=plan) as s:
        futs = s.submit_many(xs)
        for i in (0, 1, 3):                         # innocents: bitwise
            np.testing.assert_array_equal(
                np.asarray(futs[i].result(timeout=60)), ref[i])
        with pytest.raises(InjectedFault, match="cursed"):
            futs[2].result(timeout=60)              # offender: causal error
        st = s.stats
    assert st.isolated == 1 and st.retries >= 2 and _balanced(st)
    assert st.degraded == 0


def test_numerics_guard_quarantines_poisoned_rows(acc):
    plan = FaultPlan([FaultSpec(site="execute", kind="nan", requests=(1,))])
    with acc.serve(max_batch=2, buckets=(2,), max_wait_ms=20.0, warmup=True,
                   fault_plan=plan, guard_numerics=True) as s:
        futs = s.submit_many(_x(seed=4, n=2))
        assert np.isfinite(np.asarray(futs[0].result(timeout=60))).all()
        with pytest.raises(NumericsError):
            futs[1].result(timeout=60)
        st = s.stats
    assert st.isolated >= 1 and _balanced(st)


# -- deadlines and bounded admission ----------------------------------------

def test_deadline_exceeded_while_queued(acc):
    plan = FaultPlan([FaultSpec(site="dispatch", kind="delay", at=(0,),
                                delay_ms=400.0)])
    with acc.serve(max_batch=2, buckets=(2,), max_wait_ms=1.0, warmup=True,
                   fault_plan=plan) as s:
        f = s.submit(_x(), deadline_ms=100.0)
        with pytest.raises(DeadlineExceeded, match="deadline"):
            f.result(timeout=60)
        st = s.stats
    assert st.deadline_exceeded == 1 and _balanced(st)


def test_session_default_deadline_applies(acc):
    plan = FaultPlan([FaultSpec(site="dispatch", kind="delay", at=(0,),
                                delay_ms=400.0)])
    with acc.serve(max_batch=2, buckets=(2,), max_wait_ms=1.0, warmup=True,
                   fault_plan=plan, deadline_ms=100.0) as s:
        with pytest.raises(DeadlineExceeded):
            s.submit(_x()).result(timeout=60)


def test_queue_limit_sheds_with_overloaded(acc):
    plan = FaultPlan([FaultSpec(site="dispatch", kind="delay",
                                delay_ms=250.0)])
    with acc.serve(max_batch=1, buckets=(1,), max_wait_ms=1.0, warmup=True,
                   fault_plan=plan, queue_limit=2, on_overload="shed") as s:
        futs = [s.submit(_x()) for _ in range(8)]
        shed = [f for f in futs if f.done()
                and isinstance(f.exception(timeout=0), Overloaded)]
        assert shed                                 # overflow shed instantly
        for f in futs:
            if f not in shed:
                f.result(timeout=120)               # admitted ones complete
        st = s.stats
    assert st.shed == len(shed) and _balanced(st)


def test_queue_limit_block_admits_everything(acc):
    plan = FaultPlan([FaultSpec(site="dispatch", kind="delay",
                                delay_ms=100.0)])
    with acc.serve(max_batch=1, buckets=(1,), max_wait_ms=1.0, warmup=True,
                   fault_plan=plan, queue_limit=2, on_overload="block") as s:
        futs = [s.submit(_x()) for _ in range(6)]   # submit blocks, not sheds
        for f in futs:
            f.result(timeout=120)
        st = s.stats
    assert st.shed == 0 and st.requests == 6 and _balanced(st)


def test_serve_rejects_bad_failure_kwargs(acc):
    with pytest.raises(ValueError, match="on_overload"):
        acc.serve(max_batch=2, queue_limit=2, on_overload="explode")
    with pytest.raises(ValueError, match="queue_limit"):
        acc.serve(max_batch=2, queue_limit=0)


# -- no degradation: a failed hopper batch is bisected on hopper -------------

def test_hopper_failure_is_bisected_never_degraded(acc_hopper):
    """A one-shot ``execute`` error on a hopper batch of two requests: each
    half re-runs on the same hopper entry at the same bucket and offsets, so
    both requests come back bit for bit, and no executor is lowered for the
    torch backend."""
    xs = _x(seed=7, n=2)
    kw = dict(max_batch=2, buckets=(2,), max_wait_ms=20.0, warmup=True)
    with acc_hopper.serve(**kw) as s:
        ref = [np.asarray(f.result(timeout=60)) for f in s.submit_many(xs)]
    plan = FaultPlan([FaultSpec(site="execute", kind="error", at=(0,),
                                match=(("backend", "hopper"),))])
    cache = acc_hopper.runtime.cache
    with acc_hopper.serve(fault_plan=plan, **kw) as s:
        misses = cache.stats.misses
        got = [np.asarray(f.result(timeout=60)) for f in s.submit_many(xs)]
        st = s.stats
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(plan.fired()) == 1 and plan.counts()["execute"] == 3
    assert (st.retries, st.isolated, st.errors, st.degraded) == (2, 0, 0, 0)
    assert _balanced(st) and cache.stats.misses == misses


def test_refused_kernel_launch_fails_typed_never_torch(acc_hopper,
                                                       monkeypatch):
    """A wrapper that refuses its launch (a Python-level failure) in every
    hopper GEMM: each request, bulk or coalesced, fails with the wrapper's
    own error after bisection; nothing is re-run on the torch lowering."""
    def refuse(*args, **kwargs):
        raise RuntimeError("kernel launch failed (refused)")

    monkeypatch.setattr(conv_ops, "conv_gemm_f32", refuse)
    monkeypatch.setattr(conv_ops, "conv_implicit_f32", refuse)
    monkeypatch.setattr(gemm_ops, "bmm_f32", refuse)
    with pytest.raises(RuntimeError, match="refused"):
        acc_hopper(_x(n=2))
    cache = acc_hopper.runtime.cache
    with acc_hopper.serve(max_batch=2, buckets=(2,), max_wait_ms=1.0) as s:
        misses = cache.stats.misses
        with pytest.raises(RuntimeError, match="refused"):
            s.run_many(list(_x(n=2)))
        with pytest.raises(RuntimeError, match="refused"):
            s.submit(_x(n=2)).result(timeout=60)
        st = s.stats
    assert (st.requests, st.errors, st.isolated, st.degraded) == (0, 3, 3, 0)
    assert _balanced(st) and cache.stats.misses == misses


# -- staging entries are bound to pipeline slots --------------------------------

def test_staging_entries_stay_bound_to_their_slots(acc, monkeypatch):
    """Three concurrent ``run_many`` callers, coalesced ``submit`` traffic
    and a one-shot ``execute`` error in the middle of the stream: no
    staging entry is handed to a batch while another batch holds it, at
    most pool-capacity entries are held at once, every entry comes back,
    and every bulk result equals a fault-free run bit for bit."""
    held, seen, peak, lock = set(), set(), [0], threading.Lock()
    take, give = api.ServingSession._take_stage, api.ServingSession._give_stage

    def checked_take(self, bucket):
        stage = take(self, bucket)
        with lock:
            assert id(stage) not in held, "entry handed out while held"
            held.add(id(stage))
            seen.add(id(stage))
            peak[0] = max(peak[0], len(held))
        return stage

    def checked_give(self, bucket, stage, *, settled):
        with lock:
            held.remove(id(stage))
        give(self, bucket, stage, settled=settled)

    callers = [list(_x(seed=20 + c, n=8)) for c in range(3)]
    kw = dict(max_batch=2, buckets=(2,), max_wait_ms=1.0, warmup=True)
    with acc.serve(**kw) as s:
        refs = [s.run_many(xs) for xs in callers]
    monkeypatch.setattr(api.ServingSession, "_take_stage", checked_take)
    monkeypatch.setattr(api.ServingSession, "_give_stage", checked_give)
    plan = FaultPlan([FaultSpec(site="execute", kind="error", at=(5,))])
    with acc.serve(fault_plan=plan, **kw) as s:
        with ThreadPoolExecutor(3) as pool:
            bulk = [pool.submit(s.run_many, xs) for xs in callers]
            singles = s.submit_many(list(_x(seed=30, n=6)))
            outs = [f.result(timeout=120) for f in bulk]
            for f in singles:
                assert np.isfinite(f.result(timeout=120)).all()
        st = s.stats
    for out, ref in zip(outs, refs):
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    assert len(plan.fired()) == 1 and st.retries == 2 and st.errors == 0
    assert st.requests == 30 and _balanced(st)
    assert not held and 1 <= peak[0] <= 3 and len(seen) <= 3


# -- run_many under faults ----------------------------------------------------

def test_run_many_reports_suppressed_secondary_errors(acc, caplog):
    plan = FaultPlan([
        FaultSpec(site="execute", kind="error", requests=(1,),
                  message="first"),
        FaultSpec(site="execute", kind="error", requests=(6,),
                  message="second"),
    ])
    xs = list(_x(seed=5, n=8))
    with acc.serve(max_batch=2, buckets=(2,), max_wait_ms=1.0, warmup=True,
                   fault_plan=plan) as s:
        with caplog.at_level(logging.ERROR, logger="repro_torch.serving"):
            with pytest.raises(InjectedFault, match="first") as ei:
                s.run_many(xs)
        st = s.stats
    assert [str(e) for e in ei.value.secondary_errors] == ["second"]
    assert any("suppressed" in r.getMessage() for r in caplog.records)
    assert _balanced(st)


def test_run_many_isolates_cursed_request_bitwise(acc):
    xs = list(_x(seed=6, n=4))
    with acc.serve(max_batch=4, buckets=(4,), warmup=True) as s:
        ref = [np.asarray(y) for y in s.run_many(xs)]
    plan = FaultPlan([FaultSpec(site="execute", kind="error", requests=(0,),
                                message="cursed")])
    with acc.serve(max_batch=4, buckets=(4,), warmup=True,
                   fault_plan=plan) as s:
        with pytest.raises(InjectedFault, match="cursed"):
            s.run_many(xs)
        st = s.stats
    assert st.isolated == 1 and _balanced(st)
    with acc.serve(max_batch=4, buckets=(4,), warmup=True) as s:
        again = [np.asarray(y) for y in s.run_many(xs)]
    for a, b in zip(again, ref):
        np.testing.assert_array_equal(a, b)


# -- lifecycle edge cases -------------------------------------------------------

def test_close_with_requests_in_flight_resolves_everything(acc):
    plan = FaultPlan([FaultSpec(site="dispatch", kind="delay",
                                delay_ms=150.0)])
    s = acc.serve(max_batch=1, buckets=(1,), max_wait_ms=1.0, warmup=True,
                  fault_plan=plan)
    try:
        futs = [s.submit(_x()) for _ in range(4)]
    finally:
        s.close()                                  # while batches in flight
    for f in futs:                                 # liveness: all resolved,
        assert f.done()                            # result or typed error
        try:
            f.result(timeout=0)
        except Exception:  # noqa: BLE001 — typed error is a resolution too
            pass
    assert _balanced(s.stats)


def test_double_close_is_idempotent_even_after_crash(acc):
    plan = FaultPlan([FaultSpec(site="dispatch", kind="kill", at=(0,))])
    s = acc.serve(max_batch=2, buckets=(2,), max_wait_ms=1.0, warmup=True,
                  fault_plan=plan, supervise=False)   # no watchdog rescue
    try:
        f = s.submit(_x())
        time.sleep(0.3)                            # let the worker die
    finally:
        s.close()
    s.close()                                      # second close: no-op
    with pytest.raises(PipelineCrashed):
        f.result(timeout=0)
    assert _balanced(s.stats)


def test_run_many_empty_and_zero_max_wait(acc):
    with acc.serve(max_batch=2, buckets=(2,), max_wait_ms=0.0,
                   warmup=False) as s:
        assert s.run_many([]) == []                # no work: no batches
        y = s.submit(_x()).result(timeout=60)      # zero-wait admitter cuts
        assert np.asarray(y).shape == (10,)        # singleton batches
        assert s.stats.batches >= 1
        assert s.stats.compile_ms > 0.0            # first use counted
    assert _balanced(s.stats)


def test_submit_after_close_still_raises(acc):
    s = acc.serve(max_batch=2, buckets=(2,), warmup=False)
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(_x())
    with pytest.raises(RuntimeError, match="closed"):
        s.run_many([_x()])


# -- the supervision primitives --------------------------------------------------

def test_heartbeat_monitor_detects_stragglers_and_dead():
    mon = HeartbeatMonitor(n_workers=3, window=8, zscore_threshold=3.0,
                           dead_after_s=5.0)
    now = 100.0
    for step in range(8):
        for w in range(3):
            slow = 4.0 if w == 2 else 1.0          # worker 2 is 4x slower
            mon.report(w, step_time=slow, now=now)
        now += 1.0
    assert mon.stragglers() == [2]
    assert mon.dead(now=now) == []                 # everyone reported
    assert mon.dead(now=now + 10.0) == [0, 1, 2]   # silence kills them all


def test_thread_supervisor_only_flags_hung_when_busy():
    sup = ThreadSupervisor(("dispatch", "drain"), hang_after_s=1.0)
    sup.beat("dispatch", now=0.0)
    sup.beat("drain", now=0.0)
    assert sup.hung(now=10.0) == []                # idle: silence is normal
    sup.update_busy(True, now=10.0)                # arming re-reports all
    assert sup.hung(now=10.5) == []
    assert sorted(sup.hung(now=20.0)) == ["dispatch", "drain"]
    sup.beat("drain", now=20.0)
    assert sup.hung(now=20.5) == ["dispatch"]


def test_deadline_table_orders_and_pops_due():
    t = DeadlineTable()
    assert t.next_at() is None
    assert t.add(5.0, "b") and t.add(3.0, "a")     # new-min flags
    assert not t.add(9.0, "c")
    assert t.next_at() == 3.0 and len(t) == 3
    assert t.pop_due(6.0) == ["a", "b"]
    assert t.pop_due(6.0) == [] and len(t) == 1


def test_hung_thread_restarts_the_pipeline(acc):
    """``hang_after_s``: a dispatch worker silent past the window while
    the session has work is treated like a dead one."""
    plan = FaultPlan([FaultSpec(site="dispatch", kind="delay", at=(0,),
                                delay_ms=1500.0)])
    with acc.serve(max_batch=1, buckets=(1,), max_wait_ms=1.0, warmup=True,
                   fault_plan=plan, hang_after_s=0.3) as s:
        first = s.submit(_x())
        time.sleep(0.05)        # the worker holds ``first`` in its delay
        queued = s.submit(_x())     # pending work: the silence is a hang
        for f in (first, queued):
            with pytest.raises(PipelineCrashed, match="hung"):
                f.result(timeout=60)
        assert s.submit(_x()).result(timeout=60) is not None
        st = s.stats
    assert st.watchdog_restarts >= 1 and _balanced(st)


# -- Fleet passthrough -------------------------------------------------------

def test_fleet_sessions_share_failure_model(acc):
    plan = FaultPlan([FaultSpec(site="execute", kind="error", requests=(0,),
                                message="cursed")])
    fleet = api.Fleet({"m": acc}, max_batch=2, buckets=(2,),
                      max_wait_ms=1.0, warmup=True, fault_plan=plan,
                      deadline_ms=30_000.0)
    try:
        with pytest.raises(InjectedFault, match="cursed"):
            fleet.submit("m", _x()).result(timeout=60)
        assert fleet.submit("m", _x()).result(timeout=60) is not None
        st = fleet.sessions["m"].stats
        assert st.isolated == 1 and _balanced(st)
    finally:
        fleet.close()
