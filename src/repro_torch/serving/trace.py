"""Where a :class:`~repro_torch.api.ServingSession`'s requests spend their
time: each device batch traced on the host clock and on the card's events,
and the interpreter's garbage-collection pauses beside them.

:class:`SessionTrace` wraps one session's own methods on the instance (the
session's code is unchanged): the slot wait, the staging, the launch (with
timed events recorded on the session's stream before and after it, whose
elapsed time is the batch's device time), the drain and the delivery. :meth:`SessionTrace.summary` gives the window's
latency percentiles, its device busy share, the pauses and how much of the
slowest twentieth of requests lay inside a pause, and the longest gaps
between two batches with what happened in them.

Run on a card, one arrival window of single images per rate, each in a
session of its own as ``chip_smoke.py``'s phase 3b runs them::

    PYTHONPATH=src python -m repro_torch.serving.trace --path vgg16_fp32 \\
        --rates 1368 1068 [--clients 2] [--gc freeze] [--out trace.json]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import threading
import time

import numpy as np

# a pause this long or longer counts in the tail attribution
PAUSE_MS = 5.0


def _pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


class SessionTrace:
    """Per-batch host times and device events of one session, and the
    process's garbage-collection pauses, from :meth:`attach` to
    :meth:`detach`. Every time is ``time.monotonic()``, the session's own
    clock for request submission."""

    def __init__(self):
        self.batches: list[dict] = []
        # (start, ms, generation, objects collected)
        self.pauses: list[tuple[float, float, int, int]] = []
        self._by_group: dict[int, dict] = {}
        self._by_flight: dict[int, dict] = {}
        self._slot: dict | None = None
        self._gc_t0 = 0.0
        self._lock = threading.Lock()

    # -- wiring -------------------------------------------------------------
    def attach(self, session) -> "SessionTrace":
        import torch
        orig = dict(acquire=session._slots.acquire,
                    stage=session._stage_group, launch=session._launch,
                    to_host=session._to_host, deliver=session._deliver)

        def acquire(*a, **k):
            t0 = time.monotonic()
            ok = orig["acquire"](*a, **k)
            self._slot = dict(t_slot0=t0, t_slot1=time.monotonic())
            return ok

        def stage_group(group, n):
            out = orig["stage"](group, n)
            rec = dict(self._slot or {}, n=n, bucket=out[0],
                       backlog=len(session._pending),
                       t_submit=[r.t_submit for r in group])
            self._slot = None
            with self._lock:
                self._by_group[id(group)] = rec
                self.batches.append(rec)
            return out

        def timed_event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(session._stream)
            return ev

        def launch_(bucket, stage_, group):
            rec = self._by_group.get(id(group))
            timed = session._cuda and rec is not None
            ev0 = timed_event() if timed else None
            t0 = time.monotonic()
            y = orig["launch"](bucket, stage_, group)
            t1 = time.monotonic()
            if rec is not None:
                rec.update(t_launch0=t0, t_launch1=t1, ev0=ev0,
                           ev1=timed_event() if timed else None)
                self._by_flight[id(y)] = rec
            return y

        def to_host_(y):
            t0 = time.monotonic()
            out = orig["to_host"](y)
            rec = self._by_flight.pop(id(y), None)
            if rec is not None:
                rec.update(t_drain0=t0, t_drain1=time.monotonic())
            return out

        def deliver_(group, y_np):
            orig["deliver"](group, y_np)
            rec = self._by_group.pop(id(group), None)
            if rec is not None:
                rec["t_done"] = time.monotonic()

        session._slots.acquire = acquire
        session._stage_group = stage_group
        session._launch = launch_
        session._to_host = to_host_
        session._deliver = deliver_
        gc.callbacks.append(self._on_gc)
        return self

    def detach(self) -> None:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.monotonic()
        else:
            self.pauses.append((self._gc_t0,
                                (time.monotonic() - self._gc_t0) * 1e3,
                                info["generation"], info["collected"]))

    # -- reading ------------------------------------------------------------
    def summary(self, t_start: float, t_end: float) -> dict:
        """The window ``[t_start, t_end]`` (monotonic seconds): call after
        every request of it resolved and its events completed."""
        done = [b for b in self.batches if "t_done" in b]
        lat = [(b["t_done"] - t) * 1e3 for b in done for t in b["t_submit"]]
        span = t_end - t_start
        dev = []
        for b in done:
            if b.get("ev0") is not None and b.get("ev1") is not None:
                b["device_ms"] = b["ev0"].elapsed_time(b["ev1"])
                dev.append(b["device_ms"])
        pauses = [p for p in self.pauses if t_start <= p[0] <= t_end]
        long_pauses = [p for p in pauses if p[1] >= PAUSE_MS]
        p95 = _pct(lat, 95)

        def in_pause(t0, t1):
            return any(p0 < t1 and p0 + ms / 1e3 > t0
                       for p0, ms, _, _ in long_pauses)

        tail = [(t, b) for b in done for t in b["t_submit"]
                if p95 is not None and (b["t_done"] - t) * 1e3 >= p95]

        def part(b, t):
            return {"queue_ms": (b.get("t_slot0", t) - t) * 1e3,
                    "slot_ms": (b.get("t_slot1", 0) - b.get("t_slot0", 0))
                    * 1e3,
                    "launch_ms": (b.get("t_launch1", 0)
                                  - b.get("t_launch0", 0)) * 1e3,
                    "launch_to_drained_ms": (b.get("t_drain1", 0)
                                             - b.get("t_launch1", 0)) * 1e3,
                    "deliver_ms": (b["t_done"] - b.get("t_drain1", 0)) * 1e3}

        def mean_parts(items):
            parts = [part(b, t) for t, b in items]
            return {k: float(np.mean([p[k] for p in parts]))
                    for k in parts[0]} if parts else {}

        # the longest gaps between two batches' slot requests
        starts = sorted(b["t_slot0"] for b in done if "t_slot0" in b)
        gaps = []
        for a, b in zip(starts, starts[1:]):
            gaps.append((b - a, a, b))
        gaps.sort(reverse=True)
        top_gaps = []
        for g, a, b in gaps[:3]:
            over = [p for p in pauses if p[0] < b and p[0] + p[1] / 1e3 > a]
            top_gaps.append({
                "gap_ms": g * 1e3, "at_s": a - t_start,
                "gc_ms_inside": float(sum(p[1] for p in over)),
                "gc_generations": sorted({p[2] for p in over})})
        # the tail's bursts: its requests by submit time, split where two
        # lie more than 50 ms apart
        bursts = []
        for t, b in sorted(tail, key=lambda tb: tb[0]):
            ms = (b["t_done"] - t) * 1e3
            if bursts and t - bursts[-1]["end"] <= 0.05:
                bursts[-1].update(end=t, n=bursts[-1]["n"] + 1,
                                  max_ms=max(bursts[-1]["max_ms"], ms))
            else:
                bursts.append(dict(start=t, end=t, n=1, max_ms=ms))
        bursts.sort(key=lambda x: -x["n"])
        buckets = {}
        for b in done:
            if "device_ms" in b:
                buckets.setdefault(b["bucket"], []).append(b["device_ms"])
        return {
            "requests": len(lat), "batches": len(done),
            "latency_p50_ms": _pct(lat, 50), "latency_p95_ms": p95,
            "latency_p99_ms": _pct(lat, 99),
            "latency_max_ms": max(lat) if lat else None,
            "device_busy_share": (sum(dev) / 1e3 / span) if dev else None,
            "device_ms_by_bucket": {str(k): float(np.median(v))
                                    for k, v in sorted(buckets.items())},
            "backlog_max": max((b["backlog"] for b in done), default=0),
            "gc_pauses": len(pauses),
            "gc_ms": float(sum(p[1] for p in pauses)),
            "gc_max_ms": max((p[1] for p in pauses), default=0.0),
            # (at s, ms, generation, objects collected)
            "gc_long_pauses": [(round(p[0] - t_start, 4), round(p[1], 3),
                                p[2], p[3]) for p in long_pauses],
            "tail_requests": len(tail),
            "tail_share_in_pause": (sum(in_pause(t, b["t_done"])
                                        for t, b in tail) / len(tail)
                                    if tail else None),
            "tail_parts_ms": mean_parts(tail),
            "all_parts_ms": mean_parts([(t, b) for b in done
                                        for t in b["t_submit"]]),
            "top_gaps": top_gaps,
            "tail_bursts": [{"at_s": x["start"] - t_start,
                             "span_ms": (x["end"] - x["start"]) * 1e3,
                             "requests": x["n"], "max_ms": x["max_ms"]}
                            for x in bursts[:5]],
        }


def run_window(acc, images: np.ndarray, rate: float, n: int, *,
               clients: int = 1, seed: int = 0, max_batch: int = 8) -> dict:
    """``n`` single images drawn from ``images``, submitted at open-loop
    Poisson ``rate`` (split evenly over ``clients`` threads) into a session
    of its own, traced; returns the trace's summary with the offered and
    served rates."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(len(images), size=n)
    at = np.cumsum(rng.exponential(1.0 / rate, n))
    session = acc.serve(max_batch=max_batch, warmup=True)
    trace = SessionTrace().attach(session)
    futs: list = [None] * n
    late = [0.0] * clients

    def client(c):
        for i in range(c, n, clients):
            delay = t0 + at[i] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                late[c] = max(late[c], -delay)
            futs[i] = session.submit(images[pick[i]])

    try:
        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        submit_s = time.monotonic() - t0
        for f in futs:
            f.result(timeout=300)
        t1 = time.monotonic()
    finally:
        session.close()
        trace.detach()
    out = trace.summary(t0, t1)
    out.update(rate=rate, clients=clients,
               offered_images_per_s=n / submit_s,
               served_images_per_s=n / (t1 - t0),
               client_late_max_ms=max(late) * 1e3)
    return out


def main(argv=None) -> int:
    import torch

    from repro_torch.models import resnet, vgg
    from repro_torch import api
    from repro_torch.core import perf_model as pm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", required=True,
                    choices=["vgg16_fp32", "vgg16_int8", "resnet18_fp32",
                             "resnet18_int8"])
    ap.add_argument("--rates", type=float, nargs="+", required=True,
                    help="offered images/s, one window each")
    ap.add_argument("--images", type=int, default=4096)
    ap.add_argument("--clients", type=int, default=1)
    ap.add_argument("--gc", choices=["on", "freeze"], default="on",
                    help="freeze: serve inside api.settled_heap(), so a "
                         "full collection skips every object made before")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the summaries here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    model, dtype = args.path.split("_")
    specs = (vgg.network_specs(224, 1, n_classes=1000) if model == "vgg16"
             else resnet.resnet18_specs(128, 1, n_classes=1000))
    img = 224 if model == "vgg16" else 128
    acc = api.Accelerator.build(specs, pm.V5E, batch=8, backend="hopper",
                                dtype="int8" if dtype == "int8"
                                else "float32", seed=args.seed,
                                device="cuda")
    images = np.random.default_rng(args.seed).standard_normal(
        (128, img, img, 3)).astype(np.float32)
    acc(images[:8])
    torch.cuda.synchronize()
    name = torch.cuda.get_device_name(0)
    heap = collections.Counter(type(o).__name__ for o in gc.get_objects())
    print(f"{args.path}: {sum(heap.values())} objects tracked by the "
          f"collector after the build; most: {heap.most_common(8)}",
          flush=True)
    results = []
    with (api.settled_heap() if args.gc == "freeze"
          else contextlib.nullcontext()):
        for i, rate in enumerate(args.rates):
            s = run_window(acc, images, rate, args.images,
                           clients=args.clients, seed=args.seed + i)
            s.update(path=args.path, gc=args.gc, card=name)
            results.append(s)
            print(json.dumps(s), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
