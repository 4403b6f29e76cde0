"""Where a :class:`~repro_torch.api.ServingSession`'s requests spend their
time, read from the session's spans in the span log
(``repro_torch.spans.LOG``), with the interpreter's garbage-collection
pauses beside them.

:func:`summary` gives a window's latency percentiles, its device busy share
(from the timed events each batch gets inside ``spans.recording()``), the
pauses and how much of the slowest twentieth of requests lay inside a
pause, the parts of those requests' time, the longest gaps between two
batches, and the window's split (:func:`split`): the time with no batch of
the session in flight, into an empty queue, idle holds and a batch's
staging and launch. Nothing here touches a session: the session records
its own spans.

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

from repro_torch import spans

# a pause this long or longer counts in the tail attribution
PAUSE_MS = 5.0


def _pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


class GcPauses:
    """The process's garbage-collection pauses while the block runs, as
    ``(start, ms, generation, objects collected)`` on the span clock."""

    def __init__(self):
        self.pauses: list[tuple[float, float, int, int]] = []
        self._t0 = 0.0

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t0 = spans.clock()
        else:
            self.pauses.append((self._t0,
                                (spans.clock() - self._t0) * 1e3,
                                info["generation"], info["collected"]))

    def __enter__(self) -> "GcPauses":
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        return False


def union_s(intervals, t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` that the union of ``intervals`` (pairs of
    start and end) covers."""
    total, reach = 0.0, t0
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, t1)
        if b > a:
            total += b - a
            reach = b
    return total


def _batches(session: int, t_start: float, t_end: float) -> dict | None:
    """The session's spans that overlap ``[t_start, t_end]`` (clock
    seconds), by batch id: ``{bid: {name: Span}}``, each request's span
    under ``"requests"`` in its batch. None when the log no longer holds
    ``t_start``."""
    got = spans.LOG.between(t_start, t_end)
    if got is None:
        return None
    out: dict = collections.defaultdict(dict)
    for s in got:
        if s.session != session:
            continue
        if s.name == spans.REQUEST:
            out[s.parent].setdefault("requests", []).append(s)
        elif s.name != spans.AWAIT:
            out[s.id][s.name] = s
    return dict(out)


def split(session: int, t_start: float, t_end: float) -> dict | None:
    """Shares of ``[t_start, t_end]``: ``in_flight``, the union of the
    session's batches from their launch's end to their drain's end; and of
    the rest, with no batch in flight, ``queue_empty`` (``serving.await``),
    ``idle_hold`` (``serving.hold``), ``staging`` (a batch's slot wait,
    staging and launch) and ``other``. None when the log no longer holds
    ``t_start``."""
    got = spans.LOG.between(t_start, t_end)
    if got is None:
        return None
    mine = [s for s in got if s.session == session]
    span_s = t_end - t_start
    launch = {s.id: s for s in mine if s.name == spans.LAUNCH}
    busy = [(launch[s.id].t1, s.t1) for s in mine
            if s.name == spans.DRAIN and s.id in launch]
    slot = {s.id: s.t0 for s in mine if s.name == spans.SLOT}
    prep = [(slot.get(b, s.t0), s.t1) for b, s in launch.items()]

    def idle_part(intervals):
        # the part of the union of ``intervals`` outside every batch's
        # flight: the union with the flights, less the flights alone
        return (union_s(intervals + busy, t_start, t_end)
                - union_s(busy, t_start, t_end))

    in_flight = union_s(busy, t_start, t_end)
    parts = {"in_flight": in_flight / span_s}
    for key, names in (("queue_empty", (spans.AWAIT,)),
                       ("idle_hold", (spans.HOLD,))):
        parts[key] = idle_part([(s.t0, s.t1) for s in mine
                                if s.name in names]) / span_s
    parts["staging"] = idle_part(prep) / span_s
    parts["other"] = 1.0 - sum(parts.values())
    return parts


def summary(session: int, t_start: float, t_end: float,
            pauses=()) -> dict | None:
    """The window ``[t_start, t_end]`` (clock seconds) of session
    ``session`` (``stats.session``): call after every request of it
    resolved. ``pauses`` from :class:`GcPauses`. None when the span log
    no longer holds ``t_start``."""
    by_batch = _batches(session, t_start, t_end)
    if by_batch is None:
        return None
    done = {b: d for b, d in by_batch.items() if spans.DELIVER in d}
    reqs = [(r, d) for d in done.values() for r in d.get("requests", ())
            if t_start <= r.t0 <= t_end]
    lat = [(r.t1 - r.t0) * 1e3 for r, _ in reqs]
    span = t_end - t_start
    dev, buckets = [], {}
    for d in done.values():
        if spans.DEVICE in d and spans.LAUNCH in d:
            ms = d[spans.DEVICE].count / 1e3
            dev.append(ms)
            buckets.setdefault(d[spans.LAUNCH].count, []).append(ms)
    pauses = [p for p in pauses if t_start <= p[0] <= t_end]
    long_pauses = [p for p in pauses if p[1] >= PAUSE_MS]
    p95 = _pct(lat, 95)

    def in_pause(t0, t1):
        return any(p0 < t1 and p0 + ms / 1e3 > t0
                   for p0, ms, _, _ in long_pauses)

    tail = [(r, d) for r, d in reqs
            if p95 is not None and (r.t1 - r.t0) * 1e3 >= p95]

    def part(r, d):
        slot, launch = d.get(spans.SLOT), d.get(spans.LAUNCH)
        drain = d.get(spans.DRAIN)
        if slot is None or launch is None or drain is None:
            return None
        return {"queue_ms": (slot.t0 - r.t0) * 1e3,
                "slot_ms": (slot.t1 - slot.t0) * 1e3,
                "launch_ms": (launch.t1 - launch.t0) * 1e3,
                "launch_to_drained_ms": (drain.t1 - launch.t1) * 1e3,
                "deliver_ms": (r.t1 - drain.t1) * 1e3}

    def mean_parts(items):
        parts = [p for p in (part(r, d) for r, d in items) if p is not None]
        return {k: float(np.mean([p[k] for p in parts]))
                for k in parts[0]} if parts else {}

    # the longest gaps between two batches' slot requests
    starts = sorted(d[spans.SLOT].t0 for d in done.values()
                    if spans.SLOT in d)
    gaps = sorted(((b - a, a, b) for a, b in zip(starts, starts[1:])),
                  reverse=True)
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
    for r, _ in sorted(tail, key=lambda rd: rd[0].t0):
        ms = (r.t1 - r.t0) * 1e3
        if bursts and r.t0 - bursts[-1]["end"] <= 0.05:
            bursts[-1].update(end=r.t0, n=bursts[-1]["n"] + 1,
                              max_ms=max(bursts[-1]["max_ms"], ms))
        else:
            bursts.append(dict(start=r.t0, end=r.t0, n=1, max_ms=ms))
    bursts.sort(key=lambda x: -x["n"])
    return {
        "requests": len(lat), "batches": len(done),
        "latency_p50_ms": _pct(lat, 50), "latency_p95_ms": p95,
        "latency_p99_ms": _pct(lat, 99),
        "latency_max_ms": max(lat) if lat else None,
        "device_busy_share": (sum(dev) / 1e3 / span) if dev else None,
        "device_ms_by_bucket": {str(k): float(np.median(v))
                                for k, v in sorted(buckets.items())},
        "split": split(session, t_start, t_end),
        "gc_pauses": len(pauses),
        "gc_ms": float(sum(p[1] for p in pauses)),
        "gc_max_ms": max((p[1] for p in pauses), default=0.0),
        # (at s, ms, generation, objects collected)
        "gc_long_pauses": [(round(p[0] - t_start, 4), round(p[1], 3),
                            p[2], p[3]) for p in long_pauses],
        "tail_requests": len(tail),
        "tail_share_in_pause": (sum(in_pause(r.t0, r.t1) for r, _ in tail)
                                / len(tail) if tail else None),
        "tail_parts_ms": mean_parts(tail),
        "all_parts_ms": mean_parts(reqs),
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
    of its own inside ``spans.recording()``; returns the window's
    :func:`summary` with the offered and served rates."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(len(images), size=n)
    at = np.cumsum(rng.exponential(1.0 / rate, n))
    session = acc.serve(max_batch=max_batch, warmup=True)
    futs: list = [None] * n
    late = [0.0] * clients

    def client(c):
        for i in range(c, n, clients):
            delay = t0 + at[i] - spans.clock()
            if delay > 0:
                time.sleep(delay)
            else:
                late[c] = max(late[c], -delay)
            futs[i] = session.submit(images[pick[i]])

    try:
        with spans.recording(), GcPauses() as pauses:
            t0 = spans.clock()
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            submit_s = spans.clock() - t0
            for f in futs:
                f.result(timeout=300)
            t1 = spans.clock()
    finally:
        session.close()
    out = summary(session.stats.session, t0, t1, pauses.pauses)
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
