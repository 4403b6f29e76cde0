"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 bench/run.py --workload vgg16-fp32.bulk --seed 7 --seconds 10 \\
        --trace 0

Run from the root of a checkout on a machine with the cell's NVIDIA cards.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones, the window's counters and a ``torch.profiler`` trace of a
short segment of the same traffic sent after the window, with the
device's busy time and a breakdown. The numbers that decide
``correct`` are printed, each beside its limit, as the last lines of
standard error and under ``checks`` at the end of the result. Without a
card, or with a JAX module loaded once the window has closed, it prints no
result and exits with another code than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run, at fixed paths in the checkout
CACHE = ROOT / "build" / "bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card: nothing measured")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} found")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or the JAX package loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
