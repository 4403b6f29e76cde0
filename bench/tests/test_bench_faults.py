"""``correct`` comes out false when the timed path is broken underneath,
and the TF32 control reads above each configuration's limit."""
import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import net
from bench.yardstick import compare, inputs
from bench_tiny import tiny_config, tiny_resnet18

CELLS = ["vgg16-fp32.bulk", "vgg16-fp32.bulk-b128", "vgg16-fp32.online"]
SLOW = {"vgg16-fp32.online": {"rate_per_s": 100}}


def _half_batch(y):
    """Half of the batch left out: its rows repeat the computed half's."""
    half = (len(y) + 1) // 2
    y[half:] = y[:len(y) - half]
    return y


def _altered(y, seen):
    """One answer altered where it is produced: a logit of the first row of
    the first batch moved by a hundredth of the row's largest."""
    if not seen:
        seen.append(1)
        y[0, 0] += 0.01 * np.abs(y[0]).max()
    return y


def _without_biases(build):
    """The program's biases dropped: it is built with every bias zero."""
    def wrapped(specs, *args, params, **kwargs):
        params = [(w, b.new_zeros(b.shape)) for w, b in params]
        return build(specs, *args, params=params, **kwargs)
    return staticmethod(wrapped)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "altered", "no_bias"])
def test_a_broken_path_is_not_correct(tiny_cell, monkeypatch, workload,
                                      fault):
    from repro_torch import api
    if fault == "no_bias":
        monkeypatch.setattr(api.Accelerator, "build",
                            _without_biases(api.Accelerator.build))
    else:
        seen = []
        broken = {"half_batch": _half_batch,
                  "altered": lambda y: _altered(y, seen)}[fault]
        to_host = api.ServingSession._to_host
        monkeypatch.setattr(api.ServingSession, "_to_host",
                            lambda self, y: broken(to_host(self, y)))
    cell = tiny_cell(workload, **SLOW.get(workload, {}))
    result = harness.run_cell(cell, 11, 1.0, False, device="cpu")
    assert result["correct"] is False
    gap = result["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


def test_a_dropped_skip_add_is_not_correct(tiny_cell, monkeypatch):
    """The program's residual adds leave out their skip operand."""
    from repro_torch.core import executor
    eltwise = executor.eltwise_forward

    def no_skip(cl, x, skip, relu, quant=None):
        return eltwise(cl, x, torch.zeros_like(skip), relu, quant=quant)
    monkeypatch.setattr(executor, "eltwise_forward", no_skip)
    cell = tiny_cell("vgg16-fp32.bulk", tiny_resnet18())
    result = harness.run_cell(cell, 11, 1.0, False, device="cpu")
    assert result["correct"] is False
    gap = result["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("name", ["vgg16-fp32"])
def test_control_reads_above_the_limit(name):
    config = tiny_config(name)
    limit = config["correctness"]["logit_gap_limit"]
    layers = config["layers"]
    for seed in (1, 2, 3):
        w = inputs.make_weights(layers, seed, "cpu")
        images = inputs.make_images(config, seed, "cpu")[:32]
        ref = net.logits(layers, w, images, "cpu")
        ctl = net.logits(layers, w, images, "cpu", tf32=True)
        assert compare.logit_gap(ctl, ref) > 3 * limit


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["vgg16-fp32"])
def test_control_reads_above_the_limit_at_full_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench import readings
    config = harness.load_cell(f"{name}.bulk").config
    limit = config["correctness"]["logit_gap_limit"]
    for seed in (5200000101, 5200000103, 5200000105):
        assert readings.control_gap(config, seed, torch.device("cuda")) \
            > limit


def test_the_comparison():
    ref = np.array([[1.0, -2.0, 0.5], [0.0, 4.0, 1.0]], np.float32)
    assert compare.logit_gap(ref.copy(), ref) == 0.0
    got = ref.copy()
    got[1, 0] += 0.04
    assert compare.logit_gap(got, ref) == pytest.approx(0.01)
    got[0, 0] = np.nan
    assert np.isnan(compare.logit_gap(got, ref))
    assert not compare.passed(compare.checks(float("nan"), 0, 1.0))
    assert not compare.passed(compare.checks(0.0, 1, 1.0))
    assert compare.passed(compare.checks(0.5, 0, 1.0))


def test_the_window_gap_is_the_widest_of_every_answer():
    from concurrent.futures import Future
    from bench.yardstick import traffic
    rng = np.random.default_rng(0)
    refs = rng.standard_normal((6, 5)).astype(np.float32)
    w = traffic.Window(np.array([0, 2, 1, 2, 5]), np.array([2, 2, 1, 2, 1]),
                       False, 6)
    answers = [refs[0:2] + 1e-3, refs[2:4].copy(), refs[1:2] - 5e-3,
               refs[2:4] * (1 + 2e-3)]
    for i, a in enumerate(answers):
        fut = Future()
        fut.set_result(a)
        w.n = i + 1
        w.done(i, fut)
    want = max(compare.logit_gap(a, refs[s:s + len(a)])
               for a, s in zip(answers, w.start[:4]))
    assert compare.window_gap(w, refs) == pytest.approx(want)
    assert w.seen.tolist() == [True] * 4 + [False] * 2
    bad = Future()
    bad.set_result(np.full((1, 5), np.nan, np.float32))
    w.n = 5
    w.done(4, bad)
    assert np.isnan(compare.window_gap(w, refs))
