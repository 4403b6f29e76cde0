"""The readings a cell's correctness limit is set from, in one process:
the program's ``logit_gap`` over many seeds (each a whole run of the cell,
at a short window), and the control's: the plain reference computed with
its products' operands rounded to TensorFloat-32, put in the program's
place and held to the float32 reference on the same weights and images.

    python3 bench/readings.py --workload vgg16-fp32.bulk --seconds 2 \\
        --seeds 101 102 103 ... --control-seeds 201 202 203

Run on a card, from the root of a checkout. Prints one JSON line per
reading and a summary: the program's largest reading (the lower one) and
the control's smallest (the upper one).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))


def control_gap(config: dict, seed: int, device) -> float:
    """The TF32 control's widest gap from the float32 reference over the
    cell's whole pool of images."""
    from bench.reference import net
    from bench.yardstick import compare, inputs
    layers = config["layers"]
    images = inputs.make_images(config, seed, device)
    weights = inputs.make_weights(layers, seed, device)
    ref = net.logits(layers, weights, images, device)
    ctl = net.logits(layers, weights, images, device, tf32=True)
    return compare.logit_gap(ctl, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch
    from bench import harness
    if not torch.cuda.is_available():
        harness.log("no CUDA card: nothing measured")
        return 2
    cell = harness.load_cell(args.workload)
    program, control = [], []
    for seed in args.seeds:
        res = harness.run_cell(cell, seed, args.seconds, False)
        gap = res["checks"]["logit_gap"]["value"]
        program.append(gap)
        print(json.dumps({"workload": cell.name, "side": "program",
                          "seed": seed, "logit_gap": gap,
                          "correct": res["correct"],
                          "failed": res["failed"]}), flush=True)
    for seed in args.control_seeds:
        t = time.perf_counter()
        gap = control_gap(cell.config, seed, torch.device("cuda"))
        control.append(gap)
        print(json.dumps({"workload": cell.name, "side": "control",
                          "seed": seed, "logit_gap": gap,
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": cell.name,
                      "program_max": max(program, default=None),
                      "control_min": min(control, default=None),
                      "card": harness._power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
