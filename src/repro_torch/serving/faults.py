"""Deterministic fault injection for the serving pipeline.

A :class:`FaultPlan` is a set of :class:`FaultSpec` triggers evaluated at
named pipeline boundaries (*sites*). The hardened ``api.ServingSession``
calls ``plan.visit(site, ...)`` at each boundary; matching specs then
raise, sleep, corrupt the payload, or kill the visiting thread. Matching
is purely counter-based — each site keeps an invocation ordinal and specs
fire at chosen ordinals (or for chosen request ids) — so a plan contains
**no wall-clock reads and no RNG draws at visit time**. The only
randomness is in :meth:`FaultPlan.seeded`, which pre-generates the whole
spec list from a ``numpy`` generator at construction; two plans built from
the same seed inject byte-identical schedules.

Sites (see ``docs/ARCHITECTURE.md`` "Failure model")::

    staging   caller thread, request validation/quantize     payload: request
    dispatch  worker thread, before a batch launches         no payload
    execute   just before the PE executor runs a batch       payload: staged buffer
    drain     drain thread, before the host sync             no payload
    aot_load  the AOT artifact load (not ported yet: ROADMAP  no payload
              Queue 1, item 9; nothing visits it until then)

Kinds: ``error`` (raise :class:`InjectedFault`), ``delay`` (sleep
``delay_ms``), ``nan``/``inf`` (overwrite payload rows), ``kill`` (raise
:class:`ThreadKilled`, a ``BaseException`` — the thread dies and the
session watchdog must recover).

``chaos_soak`` drives a session under a plan and checks the liveness
invariant: every submitted request resolves (result or typed error) and
the accounting balances exactly (``submitted == completed + errors +
shed``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Sequence

import numpy as np

from repro_torch.serving.errors import InjectedFault, ThreadKilled

SITES = ("staging", "dispatch", "execute", "drain", "aot_load")
KINDS = ("error", "delay", "nan", "inf", "kill")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic trigger.

    ``at``: site-invocation ordinals (0-based) this spec fires on; empty
    means *every* visit that passes the other filters. ``requests``:
    request ids the visit must involve (empty = any). ``match``: extra
    ``(key, value)`` context equality filters, e.g.
    ``(("backend", "hopper"),)`` fires only on ``hopper`` dispatches."""

    site: str
    kind: str = "error"
    at: tuple[int, ...] = ()
    requests: tuple[int, ...] = ()
    match: tuple[tuple[str, Any], ...] = ()
    delay_ms: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}: {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}: {KINDS}")


class FaultPlan:
    """Deterministic, thread-safe fault schedule over the serving sites.

    ``visit`` is called by the instrumented pipeline; it advances the
    site's ordinal, applies every matching spec, and returns the (possibly
    corrupted) payload. The fired-event log (``fired()``) is the test
    oracle: it records exactly which spec fired at which ordinal against
    which requests."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs = tuple(specs)
        self._counters: dict[str, int] = {s: 0 for s in SITES}
        self._events: list[dict] = []
        self._lock = threading.Lock()

    # -- construction -------------------------------------------------------
    @classmethod
    def seeded(cls, seed: int, *, n_faults: int = 8, horizon: int = 48,
               sites: Sequence[str] = ("dispatch", "execute", "drain"),
               kinds: Sequence[str] = ("error", "delay", "nan"),
               n_requests: int = 0, cursed_fraction: float = 0.25,
               max_delay_ms: float = 5.0) -> "FaultPlan":
        """A reproducible plan: ``n_faults`` specs drawn from ``seed``.

        Ordinals land uniformly in ``[0, horizon)`` site visits. When
        ``n_requests`` is given, ``cursed_fraction`` of the specs bind to a
        request id instead of an ordinal — a *cursed request* that fails at
        its site every time it is dispatched (the poisoned-batch isolation
        workload). All randomness happens HERE; the returned plan is a
        fixed schedule."""
        rng = np.random.default_rng(seed)
        specs = []
        for i in range(n_faults):
            site = str(sites[int(rng.integers(len(sites)))])
            kind = str(kinds[int(rng.integers(len(kinds)))])
            if kind in ("nan", "inf") and site not in ("staging", "execute"):
                site = "execute"   # corruption needs a payload to corrupt
            at: tuple[int, ...] = (int(rng.integers(horizon)),)
            requests: tuple[int, ...] = ()
            if n_requests and float(rng.random()) < cursed_fraction:
                requests, at = (int(rng.integers(n_requests)),), ()
            delay = (float(rng.uniform(0.5, max_delay_ms))
                     if kind == "delay" else 0.0)
            specs.append(FaultSpec(
                site=site, kind=kind, at=at, requests=requests,
                delay_ms=delay, message=f"seeded[{seed}] spec #{i}"))
        return cls(specs)

    # -- the boundary hook --------------------------------------------------
    def visit(self, site: str, payload=None, requests: Sequence[int] = (),
              rows: dict | None = None, **ctx):
        """Advance ``site``'s ordinal and apply matching specs.

        ``payload`` (a numpy array, mutated in place for nan/inf specs) is
        returned so call sites can write ``buf = plan.visit(...)``.
        ``rows`` maps request id -> ``(row_offset, n_rows)`` inside the
        payload, scoping corruption to a cursed request's own rows."""
        with self._lock:
            ordinal = self._counters[site]   # KeyError on unknown site
            self._counters[site] = ordinal + 1
            fired = [s for s in self.specs
                     if self._matches(s, site, ordinal, requests, ctx)]
            for s in fired:
                self._events.append({
                    "site": site, "ordinal": ordinal, "kind": s.kind,
                    "requests": tuple(requests), "message": s.message})
        # apply OUTSIDE the lock: sleeps and raises must not serialize
        # other threads' visits
        for s in fired:
            if s.kind == "delay":
                time.sleep(s.delay_ms / 1e3)
            elif s.kind in ("nan", "inf"):
                self._corrupt(payload, s, rows)
            elif s.kind == "kill":
                raise ThreadKilled(s.message or f"killed at {site}")
            else:
                raise InjectedFault(
                    s.message or f"injected fault at {site}#{ordinal}")
        return payload

    @staticmethod
    def _matches(spec: FaultSpec, site: str, ordinal: int,
                 requests: Sequence[int], ctx: dict) -> bool:
        if spec.site != site:
            return False
        if spec.at and ordinal not in spec.at:
            return False
        if spec.requests and not set(spec.requests) & set(requests):
            return False
        return all(ctx.get(k) == v for k, v in spec.match)

    @staticmethod
    def _corrupt(payload, spec: FaultSpec, rows: dict | None):
        if payload is None or not isinstance(payload, np.ndarray):
            return
        if not np.issubdtype(payload.dtype, np.floating):
            return   # int8 staging has no NaN encoding; spec is a no-op
        val = np.nan if spec.kind == "nan" else np.inf
        if spec.requests and rows:
            for rid in spec.requests:
                if rid in rows:
                    off, k = rows[rid]
                    payload[off:off + k] = val
        elif payload.size:
            payload.reshape(-1)[0] = val

    # -- oracle -------------------------------------------------------------
    def fired(self, site: str | None = None) -> list[dict]:
        """The fired-event log (copies; safe to inspect mid-run)."""
        with self._lock:
            ev = list(self._events)
        return ev if site is None else [e for e in ev if e["site"] == site]

    def counts(self) -> dict[str, int]:
        """Visits per site so far."""
        with self._lock:
            return dict(self._counters)

    def aot_hook(self):
        """A callable routing AOT artifact loads through this plan's
        ``aot_load`` site (the hook the reference's ``core.aot`` takes; the
        port's AOT loader is ROADMAP Queue 1, item 9)."""
        return lambda digest: self.visit("aot_load", digest=digest)


def chaos_soak(acc, *, plan: FaultPlan, n_requests: int = 48, seed: int = 0,
               deadline_ms: float | None = 10_000.0,
               timeout_s: float = 120.0, raise_on_failure: bool = False,
               **session_kwargs) -> dict:
    """Drive ``acc.serve(fault_plan=plan, ...)`` with a seeded request
    stream and report the liveness/accounting verdict.

    Every request's future must resolve — result or typed error — before
    ``timeout_s``; the session counters must balance exactly
    (``submitted == completed + errors + shed``). Returns the report dict;
    with ``raise_on_failure`` a violated invariant raises instead, so CI
    smoke steps fail loudly."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal(
        (n_requests, *acc.input_shape)).astype(np.float32)
    kwargs = dict(max_batch=4, max_wait_ms=2.0, warmup=True,
                  guard_numerics=True, deadline_ms=deadline_ms)
    kwargs.update(session_kwargs)
    session = acc.serve(fault_plan=plan, **kwargs)
    futs: list = []
    rejected = 0
    completed = errors = unresolved = 0
    try:
        for i in range(n_requests):
            try:
                futs.append(session.submit(xs[i]))
            except Exception:  # noqa: BLE001 — staging-site injected fault
                rejected += 1
                futs.append(None)
        t_end = time.monotonic() + timeout_s
        for f in futs:
            if f is None:
                continue
            try:
                f.result(timeout=max(0.0, t_end - time.monotonic()))
                completed += 1
            except Exception:  # noqa: BLE001 — classify via done()
                if f.done():
                    errors += 1
                else:
                    unresolved += 1
    finally:
        session.close()
    st = session.stats
    balanced = st.submitted == st.requests + st.errors + st.shed
    report = {
        "n_requests": n_requests, "rejected_at_submit": rejected,
        "completed": completed, "errors": errors, "unresolved": unresolved,
        "submitted": st.submitted, "stats_completed": st.requests,
        "stats_errors": st.errors, "shed": st.shed,
        "deadline_exceeded": st.deadline_exceeded, "retries": st.retries,
        "isolated": st.isolated, "degraded": st.degraded,
        "watchdog_restarts": st.watchdog_restarts,
        "fault_events": len(plan.fired()),
        "balanced": balanced,
        "survived": unresolved == 0 and balanced,
    }
    if raise_on_failure and not report["survived"]:
        raise RuntimeError(f"chaos soak failed liveness/accounting: {report}")
    return report
