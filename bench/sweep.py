"""Find the highest rate of single images a configuration's session
sustains: one open-loop window per offered rate, each in a session of its
own over one accelerator, opened as the benchmark opens it.

    python3 bench/sweep.py --workload vgg16-fp32.online --seed 1 \\
        --seconds 8 --rates 1000 1200 1400 1600

For each rate it prints the offered and served rates, the growth of the
backlog (requests sent and not answered) between the window's middle and
its end, and the median and 95th percentile latency from the due time. A
rate is sustained where the session serves at least 98 % of what was
offered and the backlog grows over the second half of the window by no
more than two full batches, what it can read as when nothing grows. Run
on a card, from the root of a checkout.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))

SERVED_SHARE, GROWTH_BATCHES = 0.98, 2


def window_row(rate: float, seconds: float, w, max_batch: int) -> dict:
    """One rate's row from its open-loop window ``w`` (``traffic.Window``)."""
    from bench.yardstick import latency, stats
    ok, done, sent = w.sent("ok"), w.sent("t_done"), w.sent("t_submit")
    offered = w.n / float(w.due[w.n - 1])
    served = int(ok.sum()) / (float(done[ok].max()) - w.t0)

    def backlog(t):
        return int((sent <= t).sum()) - int((ok & (done <= t)).sum())
    growth = (backlog(w.t0 + seconds) - backlog(w.t0 + seconds / 2)) \
        / (seconds / 2)
    lat = latency.due_time_ms(w)
    return {"rate_per_s": rate, "offered_per_s": offered,
            "served_per_s": served, "backlog_growth_per_s": growth,
            "latency_p50_ms": stats.percentile(lat, 50),
            "latency_p95_ms": stats.percentile(lat, 95),
            "sustained": served >= SERVED_SHARE * offered
            and growth * seconds / 2 <= GROWTH_BATCHES * max_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch
    from bench import harness
    from bench.yardstick import inputs, traffic as traffic_mod
    from repro_torch import api
    from repro_torch.kernels import common
    if not torch.cuda.is_available():
        harness.log("no CUDA card: nothing measured")
        return 2
    cell = harness.load_cell(args.workload)
    config, layers = cell.config, cell.config["layers"]
    batch = harness.batch_of(cell.traffic)
    dev = torch.device("cuda", torch.cuda.current_device())
    common.library()
    images = inputs.make_images(config, args.seed, dev)
    acc = api.Accelerator.build(
        harness.to_specs(layers), batch=batch,
        params=inputs.make_weights(layers, args.seed, dev),
        backend=config["backend"], device=dev)
    rows = []
    for rate in args.rates:
        tr = dict(cell.traffic, rate_per_s=rate)
        w = traffic_mod.plan_open(tr, args.seconds, args.seed, len(images))
        with api.settled_heap(), acc.serve(
                max_batch=batch, buckets=tuple(tr["buckets"]),
                warmup=True) as session:
            traffic_mod.run_open(session, images, w)
        rows.append(window_row(rate, args.seconds, w, batch))
        harness.log(json.dumps(rows[-1]))
        time.sleep(0.5)
    print("| offered /s | served /s | backlog growth /s | p50 ms | p95 ms "
          "| sustained |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['offered_per_s']:.1f} | {r['served_per_s']:.1f} | "
              f"{r['backlog_growth_per_s']:.1f} | {r['latency_p50_ms']:.3f} "
              f"| {r['latency_p95_ms']:.3f} | {r['sustained']} |")
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    print(f"highest sustained rate: {max(ok) if ok else 'none'}; card "
          f"{harness._power_limit()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
