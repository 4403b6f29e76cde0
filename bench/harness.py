"""One run of one cell: set-up, the measured window, the reference, the
metrics.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Everything that
belongs to one configuration, traffic mix, layer kind or metric is a file
found by its name: ``bench/configs/<config>.json`` (through the ``file`` of
its entry), ``bench/traffic/<traffic>.json``, ``bench/layers/<kind>.py``
and ``bench/reference/<kind>.py`` (``bench/layers/__init__.py``), and
``bench/metrics/<metric>.py``, whose ``read(run)`` returns the metric's
value from a :class:`Run`, or None where the run holds nothing to read. A
metric ``<base>.<part>`` with no file of its own is read by
``<base>.py``: the same quantity, split by the cells whose end-to-end
metric it moves. A cell reports every metric whose ``workloads`` name it,
or that names none. The traffic sets the batch: the accelerator is built
for, and the session serves up to, its largest bucket.

The program under test is ``repro_torch``: the harness builds an
``Accelerator`` from the configuration's layer table with weights it makes
from the seed, opens a ``ServingSession`` over it as a serving process does
(``settled_heap``, every bucket of the traffic warmed up), and sends the
traffic through ``submit`` for the window; a traffic that sets ``slots``
gives the session that many device batches in flight, and each of its
staging entries carries a batch before the window. A traced run then
profiles a segment of the same traffic (``_Tracer``), starting and
stopping the profiler only while the session has nothing in flight:
switched on and off under load, it once left a run hanging. Once the
program's state is freed, every answer is held to the plain reference
(``bench/reference/net.py``) on the same weights and images."""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench.layers import INPUT, find
from bench.reference import net
from bench.yardstick import compare, inputs, traffic as traffic_mod
from bench.yardstick import trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a table's wiring keys and the spec fields they fill
WIRING = {"from": "inp_from", "skip": "skip_from"}
COUNTERS = ("submitted", "requests", "errors", "shed", "batches",
            "dispatched_rows", "padded_rows")
# a traced run profiles a segment of the cell's traffic after the window:
# its length, and the slice of it that is read (seconds from its start)
SEGMENT_S, SLICE_AT, SLICE_S = 3.5, 1.0, 2.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def _reported(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(has {sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads(
            (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]),
        end_to_end=_reported(bench["end_to_end"], workload),
        per_layer=_reported(bench["per_layer"], workload))


@dataclasses.dataclass
class Run:
    """What a metric's reader may read. Times are ``time.perf_counter()``
    seconds; counter deltas run from the window's opening to its last
    answer, and ``window`` holds every request sent, its times and whether
    it was answered."""
    config: dict
    traffic: dict
    seconds: float
    window: traffic_mod.Window    # the requests and what became of each
    setup_s: float
    build_s: float
    capture_s: float
    stats: dict                   # SessionStats counters, window delta
    launches: dict                # kernels.common.LAUNCHES, window delta
    trace: dict | None = None     # trace.reduce of the traced slice
    slice_t: tuple | None = None  # the traced slice on the host clock
    slice_rows: int | None = None  # images dispatched in the traced slice
    # the traced run's segment of the same traffic after the window, which
    # holds the traced slice
    segment: traffic_mod.Window | None = None

    @property
    def t_end(self) -> float:
        return self.window.t0 + self.seconds

    @property
    def layers(self) -> list:
        return self.config["layers"]


def _spec_value(v):
    """A table's value as the spec takes it: lists as tuples."""
    return tuple(map(_spec_value, v)) if isinstance(v, list) else v


def to_specs(layers: list[dict]) -> list:
    """The layer table as ``repro_torch``'s spec chain: each entry as its
    kind's spec class (``bench/layers/<kind>.py``) built from every key but
    ``kind``, ``from`` and ``skip``, by the class's own field names, and
    ``from`` and ``skip`` as the indices the spec's ``inp_from`` and
    ``skip_from`` take (-1 for the input). A key the spec has no field for
    is refused, never dropped."""
    index, specs = {INPUT: -1}, []
    for i, layer in enumerate(layers):
        name = layer["name"]
        cls = find(layer["kind"]).spec()
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for key, value in layer.items():
            if key == "kind":
                continue
            if key in WIRING.values():
                raise ValueError(f"layer {name!r}: {key!r} is wired by "
                                 f"name, with {sorted(WIRING)}")
            field = WIRING.get(key, key)
            if field not in fields:
                raise ValueError(f"layer {name!r}: the port's "
                                 f"{cls.__name__} has no field {field!r} "
                                 f"for {key!r}")
            if key in WIRING:
                if value not in index:
                    raise ValueError(f"layer {name!r}: {key!r} names "
                                     f"{value!r}, no earlier layer")
                value = index[value]
            kw[field] = _spec_value(value)
        if name in index:
            raise ValueError(f"layer {name!r}: the name is taken")
        index[name] = i
        specs.append(cls(**kw))
    return specs


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro``, compared whole: ``repro_torch`` is the port)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def _counters(stats) -> dict:
    return {k: getattr(stats, k) for k in COUNTERS}


def _reader(name: str, root: Path):
    folder = root / "bench" / "metrics"
    path = folder / f"{name}.py"
    if not path.exists():
        path = folder / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: list, run: Run, root: Path = ROOT) -> dict:
    out = {}
    for m in metrics:
        value = _reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class _Tracer:
    """``torch.profiler`` over a segment of traffic, started and stopped
    while the session has nothing in flight; the slice it reads is marked
    by two annotations whose host times tie the trace's clock to the
    host's."""

    def __init__(self, session):
        from torch.profiler import ProfilerActivity, profile
        self.session = session
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.marks: list[float] = []
        self.rows: list[int] = []
        self.pauses: list[tuple[float, float, int]] = []
        self._gc_t0 = 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.pauses.append((self._gc_t0, time.perf_counter(),
                                info["generation"]))

    def _mark(self, name: str):
        with torch.profiler.record_function(name):
            self.marks.append(time.perf_counter())
        self.rows.append(self.session.stats.dispatched_rows)

    def segment(self, images, traffic: dict, seed: int):
        """Profile ``SEGMENT_S`` seconds of ``traffic`` (its own requests,
        drawn from ``seed``); returns their window."""
        w = _plan(traffic, SEGMENT_S, seed, len(images))
        hooks = ((SLICE_AT, lambda: self._mark(trace_mod.SLICE_START)),
                 (SLICE_AT + SLICE_S,
                  lambda: self._mark(trace_mod.SLICE_END)))
        self.prof.start()
        try:
            _drive(self.session, images, traffic, w, SEGMENT_S, hooks)
        finally:
            self.prof.stop()
        return w

    def close(self):
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def reduce(self, image_bytes: int) -> dict | None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        start = trace_mod.marker(data, trace_mod.SLICE_START)
        if start is None:
            return None
        off = start - self.marks[0] * 1e6
        pauses = [(a * 1e6 + off, b * 1e6 + off, g)
                  for a, b, g in self.pauses]
        return trace_mod.reduce(data, image_bytes=image_bytes,
                                pauses_us=pauses)


def _free_program():
    from repro_torch.core.program_cache import default_cache
    default_cache().clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read ({out.stderr.strip()})"


def batch_of(traffic: dict) -> int:
    """The batch a cell's accelerator is built for: the traffic's largest
    bucket."""
    return max(traffic["buckets"])


def _plan(traffic: dict, seconds: float, seed: int,
          pool: int) -> traffic_mod.Window:
    if traffic["arrival"] == "closed":
        return traffic_mod.plan_closed(traffic, seconds, seed, pool)
    if traffic["arrival"] == "poisson":
        return traffic_mod.plan_open(traffic, seconds, seed, pool)
    raise ValueError(f"unknown arrival {traffic['arrival']!r}")


def _pipeline(traffic: dict) -> dict:
    """The session's keywords for the traffic's pipeline depth: ``slots``
    device batches in flight where the traffic sets it, else the
    session's own."""
    if "slots" not in traffic:
        return {}
    from repro_torch import api
    return {"slot_pool": api._SlotPool(int(traffic["slots"]))}


def _fill(session, images, traffic: dict, w) -> None:
    """Where the traffic sets ``slots``: one request for each slot at
    once, every one waited for, so that each staging entry of the session
    has carried a batch before the window. Their answers are folded into
    the window's ``w``, to be compared with the rest."""
    if "slots" not in traffic:
        return
    k = int(traffic["images_per_request"])
    x = images[0] if traffic.get("single") else images[:k]
    for fut in session.submit_many([x] * int(traffic["slots"])):
        w.fold(0, fut.result())


def _drive(session, images, traffic: dict, w, seconds: float, hooks=()):
    """Send ``w``'s requests; returns once every one is resolved."""
    if traffic["arrival"] == "closed":
        traffic_mod.run_closed(session, images, w,
                               int(traffic["outstanding"]), seconds, hooks)
    else:
        traffic_mod.run_open(session, images, w, hooks)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             root: Path = ROOT) -> dict:
    """Run ``cell`` once; returns the result's dict (the last line)."""
    from repro_torch import api
    from repro_torch.kernels import common

    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config, traffic = cell.config, cell.traffic
    layers = config["layers"]
    batch = batch_of(traffic)
    if cuda:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        marks.append(("card", time.perf_counter()))
        common.library()
        marks.append(("kernel library", time.perf_counter()))
    weights = inputs.make_weights(layers, seed, dev)
    images = inputs.make_images(config, seed, dev)
    t_build = time.perf_counter()
    marks.append(("weights and images", t_build))
    acc = api.Accelerator.build(
        to_specs(layers), batch=batch, params=weights,
        backend=config["backend"], device=dev)
    build_s = time.perf_counter() - t_build
    del weights
    steps = ", ".join(f"{name} {t - t_prev:.3f} s" for (name, t), (_, t_prev)
                      in zip(marks, [("", t_start)] + marks))
    log(f"{cell.name}: seed {seed}; set-up: {steps}, build {build_s:.3f} s")

    closed = traffic["arrival"] == "closed"
    window = _plan(traffic, seconds, seed, len(images))
    tracer = segment = None
    with api.settled_heap():
        session = acc.serve(max_batch=batch,
                            buckets=tuple(traffic["buckets"]), warmup=True,
                            **_pipeline(traffic))
        try:
            capture_s = session.stats.compile_ms / 1e3
            _fill(session, images, traffic, window)
            before = _counters(session.stats)
            common.reset_launches()
            _drive(session, images, traffic, window, seconds)
            after = _counters(session.stats)
            launches = {k: v for k, v in common.LAUNCHES.items() if v}
            peak = (torch.cuda.max_memory_allocated(dev) if cuda else 0)
            if trace and cuda:
                tracer = _Tracer(session)
                segment = tracer.segment(images, traffic, seed + 1)
        finally:
            session.close()
            if tracer is not None:
                tracer.close()
    w = window
    setup_s = w.t0 - t_start
    ok = w.sent("ok")
    log(f"{cell.name}: set-up {setup_s:.3f} s (capture "
        f"{capture_s:.3f} s); window {seconds} s, {w.n} requests, "
        f"{int(w.sent('count').sum())} images, {int((~ok).sum())} "
        f"unanswered")
    if not closed and w.n:
        late = (w.sent("t_submit") - (w.t0 + w.sent("due"))) * 1e3
        log(f"{cell.name}: the client sent {w.n} requests, late by "
            f"median {np.median(late):.3f} ms, 95th percentile "
            f"{np.percentile(late, 95):.3f} ms, most {late.max():.3f} ms")

    run = Run(config=config, traffic=traffic, seconds=seconds, window=w,
              setup_s=setup_s, build_s=build_s,
              capture_s=capture_s,
              stats={k: after[k] - before[k] for k in COUNTERS},
              launches=launches)
    device_info = dict(_card(dev), memory_peak_bytes=int(peak))
    breakdown = None
    if tracer is not None:
        hw = config["input_resolution"]
        run.trace = tracer.reduce(4 * hw * hw * config["channels"])
        run.slice_t = (tracer.marks[0], tracer.marks[1])
        run.slice_rows = tracer.rows[1] - tracer.rows[0]
        run.segment = segment
        if run.trace is not None:
            device_info.update(busy_s=run.trace["busy_s"],
                               window_s=run.trace["window_s"])
            breakdown = {"device_ops": run.trace["device_ops"],
                         "idle_gaps": run.trace["idle_gaps"]}
        tracer = None
    del session, acc
    _free_program()

    t_ref = time.perf_counter()
    refs = net.logits(layers, inputs.make_weights(layers, seed, dev), images,
                      dev)
    gap, missing = compare.window_gap(w, refs), int((~ok).sum())
    log(f"{cell.name}: reference {time.perf_counter() - t_ref:.3f} s over "
        f"{len(images)} images; {int(ok.sum())} answers compared")
    if cuda:
        log(f"{cell.name}: card {_power_limit()}")
    checks = compare.checks(
        gap, missing, float(config["correctness"]["logit_gap_limit"]))

    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           run, root)
    result = {"correct": compare.passed(checks), "attempted": w.n,
              "failed": missing, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
