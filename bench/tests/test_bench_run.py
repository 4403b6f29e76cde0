"""A whole run on the CPU at a tiny size: the last line's shape, what the
command does without a card, and which modules a run loads."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_tiny import ROOT, tiny_dw_chain, tiny_resnet18
from bench import harness

SLOW = {"vgg16-fp32.online": {"rate_per_s": 100}}


@pytest.mark.parametrize("workload", ["vgg16-fp32.bulk",
                                      "vgg16-fp32.bulk-b128",
                                      "vgg16-fp32.online"])
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_shape(tiny_cell, workload, traced):
    cell = tiny_cell(workload, **SLOW.get(workload, {}))
    result = harness.run_cell(cell, 2 ** 31 + 7, 1.0, traced, device="cpu")
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    metrics = cell.per_layer if traced else cell.end_to_end
    units = {m["name"]: m["unit"] for m in metrics}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    if not traced:
        # on the CPU every end-to-end metric is read; the device trace's
        # are left out, as a run on a card never does
        assert set(line["metrics"]) == set(units)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("specs", [tiny_resnet18, tiny_dw_chain])
def test_other_networks_are_served_and_checked(tiny_cell, specs):
    """A residual table (inputs rerouted by ``from``, adds by ``skip``)
    and a depthwise one, served by the program and held to the
    reference."""
    cell = tiny_cell("vgg16-fp32.bulk", specs())
    result = harness.run_cell(cell, 2 ** 31 + 9, 1.0, False, device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would run")
    out = _run(["--workload", "vgg16-fp32.bulk", "--seed", "3", "--seconds",
                "1", "--trace", "0"], ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_command_fails_in_a_bare_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(["--workload", "vgg16-fp32.bulk", "--seed", "3", "--seconds",
                "1", "--trace", "0"], tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "from conftest import tiny_config\n"
        "from bench import harness\n"
        "cell = harness.load_cell('vgg16-fp32.bulk')\n"
        "cell.config = tiny_config('vgg16-fp32')\n"
        "r = harness.run_cell(cell, 5, 0.5, False, device='cpu')\n"
        "assert r['correct']\n"
        "print(harness.forbidden_modules(), 'repro_torch' in sys.modules)\n"
        % (str(ROOT / "src"), str(ROOT), str(ROOT / "bench" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_modules_compare_whole_top_level_names():
    mods = dict.fromkeys(["repro_torch", "repro_torch.api", "reproduce",
                          "repro", "repro.core.dse", "jax.numpy", "jaxlib",
                          "flax.linen", "jaxtyping", "numpy"])
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.dse"]
