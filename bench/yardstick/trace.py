"""Reduce a ``torch.profiler`` chrome trace of a slice of the window to the
device's busy time, the kernels' time per batch and the idle gaps.

The slice runs from the ``SLICE_START`` annotation to the ``SLICE_END``
one, both recorded by the harness on the host. An operation on the device
is a kernel, a copy or a memset; ``busy_s`` is the union of their
intervals inside the slice. Batches are found by their input copies (host
to device, a whole number of images): the kernels that start between the
first and the last such copy belong to the batches those copies began,
which gives the kernels' time for a known list of batch sizes. Each idle
gap is named by what the host was doing meanwhile: a garbage-collector
pause, else the traced host call (not a wait) that overlaps it most."""
from __future__ import annotations

import collections

SLICE_START = "bench.slice_start"
SLICE_END = "bench.slice_end"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")
# host calls that wait for the device; a gap during one is not their doing
WAITS = ("cudaEventSynchronize", "cudaStreamSynchronize",
         "cudaDeviceSynchronize", "cudaEventQuery", "cudaStreamWaitEvent",
         "cudaStreamQuery")
TOP = 10


def _events(trace: dict, cats) -> list[tuple[float, float, str, dict]]:
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e.get("name", ""), e.get("args") or {})
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in cats]


def marker(trace: dict, name: str) -> float | None:
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            return float(e["ts"])
    return None


def _union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(trace: dict, *, image_bytes: int, pauses_us=()) -> dict | None:
    """``pauses_us``: garbage-collector pauses as (start, end, generation)
    on the trace's clock. Returns None where the slice's markers or any
    device operation are missing."""
    lo, hi = marker(trace, SLICE_START), marker(trace, SLICE_END)
    dev = _events(trace, DEVICE_CATS)
    if lo is None or hi is None or hi <= lo or not dev:
        return None
    busy = _union([(a, b) for a, b, _, _ in dev], lo, hi)
    busy_us = sum(b - a for a, b in busy)
    if busy_us <= 0:
        return None

    by_name = collections.Counter()
    for a, b, name, _ in dev:
        a2, b2 = max(a, lo), min(b, hi)
        if b2 > a2:
            by_name[name] += b2 - a2
    device_ops = [[name, us / 1e6] for name, us in by_name.most_common(TOP)]

    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(a, b, name) for a, b, name, _ in _events(trace, HOST_CATS)
            if name not in WAITS and not name.startswith(("bench.",
                                                          "ProfilerStep"))]
    idle_gaps = [[_what_host_did(a, b, host, pauses_us), (b - a) / 1e6]
                 for a, b in gaps[:TOP]]

    copies = sorted((a, args.get("bytes")) for a, _, name, args in dev
                    if "HtoD" in name and lo <= a < hi)
    copies = [(a, n) for a, n in copies
              if isinstance(n, (int, float)) and n > 0 and n % image_bytes == 0]
    buckets, kernel_us = None, None
    if len(copies) >= 2:
        first, last = copies[0][0], copies[-1][0]
        buckets = [int(n // image_bytes) for _, n in copies[:-1]]
        kernel_us = sum(b - a for a, b, _, _ in _events(trace, ("kernel",))
                        if first <= a < last)
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "buckets": buckets,
            "kernel_s": None if kernel_us is None else kernel_us / 1e6,
            "device_ops": device_ops, "idle_gaps": idle_gaps}


def _what_host_did(a: float, b: float, host, pauses_us) -> str:
    best, best_us = "no traced host call", 0.0
    for p0, p1, gen in pauses_us:
        over = min(b, p1) - max(a, p0)
        if over > best_us:
            best, best_us = f"gc pause, generation {gen}", over
    calls = collections.Counter()
    for h0, h1, name in host:
        over = min(b, h1) - max(a, h0)
        if over > 0:
            calls[name] += over
    if calls:
        name, us = calls.most_common(1)[0]
        if us > best_us:
            best = f"host in {name}"
    return best
