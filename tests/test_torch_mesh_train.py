"""Training over a mesh of several positions (``launch/train.py``'s mesh
step) on the CPU, reduced minitron-8b in fp32, batch 8 x 16.

On a (2, 4) ``("data", "model")`` mesh of the repeated CPU device (the
batch split over two data rows, each row tensor parallel over four
``model`` positions; the placed trees are gathered whole to compare), one
step against the one-position step from the same parameters: loss and
``grad_norm`` within 1e-6 relative, the reduced gradient AdamW receives
within ``1e-6 * max(1, max|g|)`` of the whole batch's, and the updated parameters
within ``1e-4 * max(1, max|p|)``: AdamW's first step divides each gradient
element by its own magnitude (``m / (sqrt(v) + eps)``), so an element near
``eps`` turns a rounding difference of the reduction into up to a few
percent of ``lr`` (7.9e-6 at ``lr`` 5e-4 here). Against the reference's
step jitted over a (2, 4) mesh of 8 host devices (a subprocess, as
``tests/test_multidevice.py::test_sharded_train_step_runs``): loss,
``grad_norm`` and parameters within ``1e-4 * max(1, max|ref|)``. An
uneven batch is refused; the reduction and copies reach the roofline's
collective term beside each row's tensor-parallel collectives; the data
positions follow position order; over one data row, (1, 4), the mesh step
is the tensor-parallel train step itself, bit for bit, for the dense
family and the SSM family (the latter within its own limits of the
one-position step)."""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import make_rules  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, ROWS, SEQ = "minitron-8b", 8, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
CFG = get_config(ARCH).reduced()


def _one(cfg=CFG):
    return make_mesh((1, 1), ("data", "model"), device_type="cpu")


def _grid(shape=(2, 4), axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _clone(tree):
    return pytree.tree_map(lambda t: t.clone(), tree)


def _close(a, b, tol):
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def _whole(tree):
    return pytree.tree_leaves(sharding.gather(tree))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _grads_seen(monkeypatch):
    """The gradient each AdamW update receives, cloned."""
    seen, update = [], adamw.update

    def spy(cfg, grads, state, params):
        seen.append(_clone(grads))
        return update(cfg, grads, state, params)
    monkeypatch.setattr(adamw, "update", spy)
    return seen


def test_mesh_step_equals_the_one_position_step(monkeypatch):
    opt = adamw.AdamWConfig(**OPT)
    seen = _grads_seen(monkeypatch)
    p1, s1, f1, _ = train_mod.build(CFG, opt, _one())
    p2, s2, f2, _ = train_mod.build(CFG, opt, _grid(), params=_clone(p1))
    for i in range(2):
        b = batch_for_step(DataConfig(CFG.vocab_size, SEQ, ROWS), i)
        p1, s1, m1 = f1(p1, s1, b)
        p2, s2, m2 = f2(p2, s2, b)
        assert _rel(m2["loss"], m1["loss"]) <= 1e-6
        assert _rel(m2["grad_norm"], m1["grad_norm"]) <= 1e-6
        for g2, g1 in zip(_whole(seen[-1]), _whole(seen[-2])):
            assert _close(g2, g1, 1e-6)
        for a, b_ in zip(_whole(p2), _whole(p1)):
            assert _close(a, b_, 1e-4)
    assert sharding.is_split(p2) and int(s2["step"]) == 2


def test_mesh_step_over_one_data_position_is_the_plain_step():
    """(1, 4): every position holds the whole batch, so nothing is split
    over data or reduced across rows: the mesh step is bit for bit the
    train step (``steps.make_train_step``) on the same placed parameters,
    with the same collectives (the tensor-parallel ones alone), and within
    the (2, 4) limits of the one-position step."""
    opt = adamw.AdamWConfig(**OPT)
    p1, s1, f1, _ = train_mod.build(CFG, opt, _one())
    p2, s2, f2, _ = train_mod.build(CFG, opt, _grid((1, 4)),
                                    params=_clone(p1))
    p3, s3 = _clone(p2), _clone(s2)
    b = batch_for_step(DataConfig(CFG.vocab_size, SEQ, ROWS), 0)
    p1, s1, m1 = f1(p1, s1, b)
    (p2, s2, m2), st = rl.count(f2, p2, s2, b)
    (p3, s3, m3), st3 = rl.count(steps.make_train_step(CFG, opt), p3, s3, b)
    assert torch.equal(m2["loss"], m3["loss"])
    for a, b_ in zip(pytree.tree_leaves(p2), pytree.tree_leaves(p3)):
        assert torch.equal(a, b_)
    assert st.collective_counts == st3.collective_counts
    assert st.collective_bytes == st3.collective_bytes > 0
    assert "all-gather" in st.collective_counts
    assert _rel(m2["loss"], m1["loss"]) <= 1e-6
    for a, b_ in zip(_whole(p2), _whole(p1)):
        assert _close(a, b_, 1e-4)


@pytest.mark.parametrize("arch", ["mamba2-130m"])
def test_mesh_step_of_a_family_held_whole_is_the_plain_step(monkeypatch,
                                                            arch):
    """(1, 4) for the SSM family, which splits along ``model`` as the dense one
    does (the hybrid and audio families' mesh steps:
    ``tests/test_torch_tensor_parallel_ssm.py``): over one data row the
    mesh step is bit for bit the tensor-parallel train step on the same
    placed parameters, with the same collectives (the tensor-parallel ones
    alone, nothing reduced over rows), and it matches the one-position
    step: loss and ``grad_norm`` within 1e-6, and by ``adamw.step_gaps``
    each gradient leaf AdamW receives within 1e-4 of its own max|g| (the
    split sums the gated norm's variance, ``out_proj``'s rows and B and
    C's gradient in another order), the parameters within 1e-4 wherever
    the gradient is well above AdamW's eps (nearer it the first step turns
    a rounding of the gradient into any share of lr), every element the
    one-position step moved moved."""
    cfg = get_config(arch).reduced()
    opt = adamw.AdamWConfig(**OPT)
    seen = _grads_seen(monkeypatch)
    p1, s1, f1, _ = train_mod.build(cfg, opt, _one())
    p2, s2, f2, _ = train_mod.build(cfg, opt, _grid((1, 4)),
                                    params=_clone(p1))
    assert sharding.is_split(p2)
    p3, s3 = _clone(p2), _clone(s2)
    start = _clone(p1)
    b = batch_for_step(DataConfig(cfg.vocab_size, SEQ, ROWS), 0)
    b.update(train_mod.extras_for(cfg, ROWS, np.random.default_rng(0)))
    p1, s1, m1 = f1(p1, s1, b)
    (p2, s2, m2), st = rl.count(f2, p2, s2, b)
    (p3, s3, m3), st3 = rl.count(steps.make_train_step(cfg, opt), p3, s3, b)
    assert torch.equal(m2["loss"], m3["loss"])
    for a, b_ in zip(pytree.tree_leaves(p2), pytree.tree_leaves(p3)):
        assert torch.equal(a, b_)
    assert st.collective_counts == st3.collective_counts
    assert st.collective_bytes == st3.collective_bytes > 0
    assert st.collective_counts["all-reduce"] > 0
    for k in ("loss", "grad_norm"):
        assert _rel(m2[k], m1[k]) <= 1e-6
    gaps = adamw.step_gaps(opt, start, _whole(seen[1]), _whole(p2),
                           _whole(seen[0]), _whole(p1))
    assert gaps["grad"] <= 1e-4 and gaps["param"] <= 1e-4, gaps
    assert gaps["unmoved"] == 0, gaps


def test_reduction_reaches_the_collective_term():
    """(2, 4): each row's tensor-parallel collectives, then every shard's
    gradient all-reduced over the two rows (the rows of the repeated
    device read the same shards: no copy)."""
    opt = adamw.AdamWConfig(**OPT)
    params, state, step, _ = train_mod.build(CFG, opt, _grid())
    b = batch_for_step(DataConfig(CFG.vocab_size, SEQ, ROWS), 0)
    _, row_st = rl.count(steps.loss_and_grads, _clone(params),
                         train_mod.split_batch(b, 2)[0], CFG)
    _, st = rl.count(step, params, state, b)
    leaves = pytree.tree_leaves(params)
    want = {k: 2 * n for k, n in row_st.collective_counts.items()}
    want["all-reduce"] += 2 * len(leaves)
    assert st.collective_counts == want
    grad_bytes = sum(p.numel() * 4 for p in leaves)
    assert st.collective_bytes == 2 * row_st.collective_bytes \
        + 2 * grad_bytes
    roof = rl.roofline_from_stats(st, 2, torch.float32)
    assert roof.collective_s == pytest.approx(
        (row_st.collective_bytes + grad_bytes) / rl.NVLINK_BW)


def test_uneven_batch_is_refused():
    opt = adamw.AdamWConfig(**OPT)
    params, state, step, _ = train_mod.build(CFG, opt, _grid((4, 2)))
    b = batch_for_step(DataConfig(CFG.vocab_size, SEQ, 6), 0)
    with pytest.raises(ValueError, match=r"\[6\] rows does not split evenly "
                                         "over 4 data positions"):
        step(params, state, b)
    with pytest.raises(ValueError, match="does not split evenly"):
        train_mod.split_batch({"tokens": np.zeros((4, 2)),
                               "frames": np.zeros((3, 2))}, 1)


def test_data_positions_follow_position_order():
    devices = ["cpu", "meta"] * 4           # (pod, data, model) = (2, 2, 2)
    rules = make_rules(make_mesh((2, 2, 2), ("pod", "data", "model"),
                                 devices=devices))
    assert rules.dp_axes == ("pod", "data")
    assert train_mod.data_devices(rules) == [torch.device("cpu")] * 4
    swapped = make_mesh((2, 2, 2), ("model", "pod", "data"),
                        devices=["cpu"] * 4 + ["meta"] * 4)
    assert train_mod.data_devices(make_rules(swapped)) == [
        torch.device("cpu")] * 4
    fleet = make_rules(make_mesh((2,), ("batch",), devices=["cpu", "meta"]))
    assert train_mod.data_devices(fleet) == [torch.device("cpu"),
                                             torch.device("meta")]
    shards = train_mod.split_batch({"t": np.arange(8)}, 4)
    assert [s["t"].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5],
                                                 [6, 7]]


def test_mesh_step_matches_the_reference_sharded_step(tmp_path):
    out = tmp_path / "ref.pkl"
    code = textwrap.dedent(f"""
        import pickle, sys
        import jax, jax.numpy as jnp, numpy as np
        from repro.compat import make_mesh
        from repro.configs.base import get_config
        from repro.data.pipeline import DataConfig, batch_for_step
        from repro.optim import adamw
        from repro.parallel.sharding import (make_rules, param_shardings,
                                             use_rules)
        from repro.train import steps as steps_lib
        assert len(jax.devices()) == 8
        mesh = make_mesh((2, 4), ("data", "model"))
        rules = make_rules(mesh)
        cfg = get_config({ARCH!r}).reduced()
        with use_rules(rules):
            params = steps_lib.init_params(jax.random.PRNGKey(0), cfg)
        before = jax.tree.map(np.asarray, params)
        params = jax.device_put(params, param_shardings(params, rules))
        opt_state = adamw.init(params)
        step = steps_lib.make_train_step(cfg, adamw.AdamWConfig(**{OPT!r}))
        def wrapped(p, o, b):
            with use_rules(rules):
                return step(p, o, b)
        batch = batch_for_step(DataConfig(cfg.vocab_size, {SEQ}, {ROWS}), 0)
        p2, o2, m = jax.jit(wrapped, donate_argnums=(0, 1))(
            params, opt_state, jax.tree.map(jnp.asarray, batch))
        with open(sys.argv[1], "wb") as f:
            pickle.dump({{"before": before,
                          "after": jax.tree.map(np.asarray, p2),
                          "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"])}}, f)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code, str(out)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = pickle.loads(out.read_bytes())
    params = transformer.params_from_numpy(ref["before"], CFG, "cpu")
    params, state, step, _ = train_mod.build(
        CFG, adamw.AdamWConfig(**OPT), _grid(), params=params)
    params, state, m = step(params, state, batch_for_step(
        DataConfig(CFG.vocab_size, SEQ, ROWS), 0))
    assert _rel(m["loss"], ref["loss"]) <= 1e-4
    assert _rel(m["grad_norm"], ref["grad_norm"]) <= 1e-4
    assert sharding.is_split(params)
    want = steps.params_from_numpy(ref["after"], CFG, "cpu")
    for a, b_ in zip(_whole(params), pytree.tree_leaves(want)):
        assert _close(a, b_, 1e-4)
