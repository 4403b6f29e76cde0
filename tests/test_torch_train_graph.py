"""The train step the card captures (``train.steps.TrainStep``), on the
CPU.

The reference jits its train step with the parameters and the optimizer
state donated; the port's step object runs its eager function ``fn``,
which on the card it captures as one CUDA graph per parameter set (the
capture itself: ``tests/test_torch_gpu.py``). Here, at reduced configs in
fp32: each family's ``fn`` (loss, backward with remat, AdamW) traces end
to end under ``FakeTensorMode``, where any host read of a device value
raises; the route is decided from the mesh; on the CPU the step object,
through ``make_train_step`` and ``launch.train.build``, gives the old
eager step's results bit for bit over three steps; a graph whose
parameter or state leaf died is dropped before any lookup; under a
roofline count the step counts what its ``fn`` counts.
"""
import dataclasses
import gc
import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import (  # noqa: E402
    DataDependentOutputException,
    FakeTensorMode,
)
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import steps  # noqa: E402

FAMILIES = {"dense": "minitron-8b", "moe": "llama4-scout-17b-16e",
            "vlm": "llama-3.2-vision-11b", "ssm": "mamba2-130m",
            "hybrid": "zamba2-7b", "audio": "whisper-base"}
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
BATCH, SEQ = 2, 16


def _mesh(shape, devices):
    return make_mesh(shape, ("data", "model"), devices=devices)


def _batches(cfg, n: int = 3) -> list[dict]:
    """``n`` batches of BATCH x SEQ (``batch_for_step``) with the stub
    frontends' inputs (``launch.train.extras_for``)."""
    data = DataConfig(cfg.vocab_size, SEQ, BATCH)
    out = []
    for i in range(n):
        b = batch_for_step(data, i)
        b.update(train_mod.extras_for(cfg, BATCH, np.random.default_rng(i)))
        out.append(b)
    return out


def _old_step(cfg):
    """The eager step as ``make_train_step`` returned it before it became a
    step object: ``loss_and_grads`` then ``adamw.update``."""
    def step(params, opt_state, batch):
        loss, grads = steps.loss_and_grads(params, batch, cfg)
        params, opt_state, om = adamw.update(OPT, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}
    return step


@pytest.mark.parametrize("family,remat", [
    *((f, True) for f in FAMILIES), ("dense", False)])
def test_fn_traces_under_fake_tensors_without_a_host_read(family, remat):
    """Each family's ``TrainStep.fn`` on fake parameters
    (``launch.specs``), AdamW state from ``adamw.init`` and a fake batch
    of LONG_SEQ tokens (the scan attention, as the full-width steps run
    it), the forward under remat (the configs' default) and once without:
    any ``int(...)``, ``float(...)`` or ``.item()`` of a device value
    raises under the fake mode, so a host read that would break the
    capture fails here. The step updates the parameters and the state in
    place and returns them, with 0-d float32 metrics."""
    cfg = dataclasses.replace(get_config(FAMILIES[family]).reduced(),
                              remat=remat)
    mode = FakeTensorMode()
    params = specs.abstract_params(cfg, mode)
    step = steps.make_train_step(cfg, OPT)
    assert isinstance(step, steps.TrainStep)
    with mode:
        state = adamw.init(params)
        s = layers.LONG_SEQ
        batch = {"tokens": torch.empty((BATCH, s), dtype=torch.int32),
                 "targets": torch.empty((BATCH, s), dtype=torch.int32)}
        if family == "vlm":
            batch["image_embeds"] = torch.empty(
                (BATCH, cfg.n_image_tokens, cfg.d_model))
        if family == "audio":
            batch["frames"] = torch.empty(
                (BATCH, cfg.n_audio_frames, cfg.d_model))
        with pytest.raises(DataDependentOutputException):
            int(state["step"])             # the probe this test relies on
        p, o, metrics = step.fn(params, state, batch)
    assert p is params and o is state
    assert sorted(metrics) == ["grad_norm", "loss", "lr"]
    assert all(m.shape == () and m.dtype == torch.float32
               for m in metrics.values())


def test_the_route_is_decided_from_the_mesh():
    """The train step's route follows the decode's rule
    (``steps.decode_route``): no mesh, one card and a mesh that repeats
    one card are captured; distinct cards run eagerly; a CPU or meta mesh
    runs ``fn``. ``make_train_step`` reads the mesh of the current rules
    when given none, and ``launch.train.build`` returns a step object
    whose route its mesh decides."""
    cuda = [torch.device("cuda", i) for i in range(2)]
    cfg = get_config("minitron-8b").reduced()
    route = lambda mesh=None: steps.make_train_step(  # noqa: E731
        cfg, OPT, mesh).route
    assert route() == "captured"
    assert route(_mesh((1, 1), cuda[:1])) == "captured"
    assert route(_mesh((2, 1), cuda[:1] * 2)) == "captured"
    assert route(_mesh((1, 2), cuda[:1] * 2)) == "captured"
    assert route(_mesh((1, 2), cuda)) == "eager: 2 cards"
    assert route(_mesh((2, 2), cuda * 2)) == "eager: 2 cards"
    assert route(_mesh((1, 2), ["cpu"] * 2)) == "eager: cpu"
    assert route(make_mesh((1, 4), ("data", "model"),
                           device_type="meta")) == "eager: meta"
    with sharding.use_rules(sharding.make_rules(_mesh((1, 2), cuda))):
        assert steps.make_train_step(cfg, OPT).route == "eager: 2 cards"
    for shape in ((1, 1), (2, 1)):
        _, _, step, _ = train_mod.build(
            cfg, OPT, _mesh(shape, ["cpu"] * (shape[0] * shape[1])))
        assert isinstance(step, steps.TrainStep)
        assert step.route == "eager: cpu"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_object_gives_the_old_step_bit_for_bit(family):
    """Three steps through the step object of ``make_train_step``, three
    through that of ``launch.train.build`` on the CPU's (1, 1) mesh, and
    three through the old eager step, each from the same parameters and a
    fresh AdamW state: every parameter, state leaf and metric equal bit
    for bit at every step, nothing captured, AdamW's ``step`` 3."""
    cfg = get_config(FAMILIES[family]).reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batches = _batches(cfg)
    _, _, built, _ = train_mod.build(cfg, OPT, _mesh((1, 1), ["cpu"]),
                                     params=params)
    made = steps.make_train_step(cfg, OPT)
    runs = []
    for step in (_old_step(cfg), made, built):
        p = pytree.tree_map(lambda t: t.clone(), params)
        s, got = adamw.init(p), []
        for b in batches:
            p, s, m = step(p, s, b)
            got.append([t.clone() for t in pytree.tree_leaves((p, s, m))])
        assert int(s["step"]) == 3
        runs.append(got)
    assert made.trace_count == built.trace_count == 0
    for got in runs[1:]:
        for a, b in zip(got, runs[0]):
            assert len(a) == len(b)
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_graph_whose_leaves_died_is_dropped_before_any_lookup():
    """The step's table of graphs (``core.executor._GraphTable``): a graph
    holds the parameter and state leaves it updates by weak reference;
    once one of them dies (a parameter, or an AdamW moment) the graph goes
    at the next lookup of any key, so parameters restored into the freed
    memory find no graph to replay."""
    step = steps.make_train_step(get_config("minitron-8b").reduced(), OPT)
    params = [torch.zeros(4), torch.zeros(4)]
    moments = [torch.zeros(3), torch.zeros(3)]

    def graph(*held):
        return steps._TrainGraph(
            None, {"tokens": torch.zeros(1)}, {"loss": torch.zeros(())},
            tuple(weakref.ref(t) for t in held), [], {}, threading.Lock())
    for i in range(2):
        step._graphs.put(("s", i), graph(params[i], moments[i]))
    assert len(step._graphs) == 2 and step._graphs.get(("s", 0))
    params.pop(0)
    gc.collect()
    step._graphs.drop_dead()
    assert len(step._graphs) == 1
    assert step._graphs.get(("s", 0)) is None
    assert step._graphs.get(("s", 1)) is not None
    moments.pop(1)
    gc.collect()
    assert step._graphs.get(("s", 1)) is None and len(step._graphs) == 0


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2)])
def test_counted_step_counts_what_its_fn_counts(shape):
    """Under ``roofline.counting()`` the step runs its eager ``fn`` (a
    replay would dispatch no op): reduced minitron-8b through
    ``launch.train.build`` on CPU meshes of one and two positions, one
    counted step through the step object and one through ``fn`` from
    copies of the same parameters and state: equal FLOPs, bytes,
    collectives, peak and per-position figures, equal results."""
    cfg = get_config("minitron-8b").reduced()
    params, state, step, _ = train_mod.build(
        cfg, OPT, _mesh(shape, ["cpu"] * (shape[0] * shape[1])))
    copy = pytree.tree_map(lambda t: t.clone(), (params, state))
    b = _batches(cfg, 1)[0]
    (p1, s1, m1), st1 = roofline.count(step, params, state, b)
    (p2, s2, m2), st2 = roofline.count(step.fn, *copy, b)
    assert st1.flops > 0 and st1.bytes_accessed > 0
    assert st1 == st2
    assert all(torch.equal(x, y) for x, y in zip(
        pytree.tree_leaves((p1, s1, m1)), pytree.tree_leaves((p2, s2, m2))))
