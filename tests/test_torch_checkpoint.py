"""The port's checkpoints and fault tolerance against the reference's
(ports of ``tests/test_integration.py``'s checkpoint cases): the on-disk
format interchanges both ways bit for bit, ``run_with_recovery`` keeps the
reference's log and replays every step exactly once, and
``elastic_restore`` places every leaf where the caller's placement tree
says. Everything runs on the CPU (``device="cpu"`` or explicit
placements)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as r_api  # noqa: E402
from repro.checkpoint import checkpoint as r_ckpt  # noqa: E402
from repro.checkpoint.fault_tolerance import (  # noqa: E402
    run_with_recovery as r_run_with_recovery,
)
from repro.models import vgg as r_vgg  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    HeartbeatMonitor,
    elastic_restore,
    run_with_recovery,
)
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.models import vgg  # noqa: E402


def _trees():
    """The same reduced-VGG16 parameter tree in both packages, with int8 and
    int32 leaves and a dict whose insertion order is not sorted."""
    r_params = r_api.random_params(r_vgg.network_specs(32, 16, n_classes=10),
                                   seed=0)
    t_params = api.random_params(vgg.network_specs(32, 16, n_classes=10),
                                 seed=0, device="cpu")
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (3, 3, 4, 8)).astype(np.int8)
    b = rng.integers(-2 ** 20, 2 ** 20, (8,)).astype(np.int32)
    r_tree = {"params": r_params,
              "quant": {"w": jnp.asarray(q), "b": jnp.asarray(b)},
              "step": jnp.asarray(np.int32(7))}
    t_tree = {"step": torch.tensor(7, dtype=torch.int32),
              "quant": {"w": torch.from_numpy(q), "b": torch.from_numpy(b)},
              "params": t_params}
    return r_tree, t_tree


def _leaves_equal(t_tree, r_tree):
    from jax.tree_util import tree_flatten_with_path
    from torch.utils._pytree import tree_flatten_with_path as t_flatten

    def key(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
    r = {key(p): np.asarray(v) for p, v in tree_flatten_with_path(r_tree)[0]}
    t = {key(p): v.numpy() for p, v in t_flatten(t_tree)[0]}
    assert set(r) == set(t)
    for k in r:
        assert r[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(r[k], t[k], err_msg=k)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    r_tree, t_tree = _trees()
    r_ckpt.save(str(tmp_path), 3, r_tree, extra_meta={"mesh": "1x1"})
    got, step = ckpt.restore(str(tmp_path), t_tree, device="cpu")
    assert step == 3 == ckpt.latest_step(str(tmp_path))
    _leaves_equal(got, r_tree)
    assert got["params"][0][0].device == torch.device("cpu")


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port writes, the reference restores: bit for bit, the same
    keys and manifest (compared as dicts: the packages flatten dicts in
    different orders) and the same ``LATEST``."""
    r_tree, t_tree = _trees()
    d_t, d_r = tmp_path / "t", tmp_path / "r"
    ckpt.save(str(d_t), 5, t_tree, extra_meta={"mesh": "1x1"})
    r_ckpt.save(str(d_r), 5, r_tree, extra_meta={"mesh": "1x1"})
    got, step = r_ckpt.restore(str(d_t), r_tree)
    assert step == 5
    _leaves_equal(t_tree, got)
    assert _manifest(d_t, 5) == _manifest(d_r, 5)
    assert (d_t / "LATEST").read_text() == (d_r / "LATEST").read_text() \
        == "step_00000005"
    with np.load(d_t / "step_00000005" / "arrays.npz") as a, \
            np.load(d_r / "step_00000005" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_crash_recovery(tmp_path):
    """A step that dies mid-run resumes from the last checkpoint; the log
    and the final state are the reference's."""
    def make_step(add):
        calls = {"n": 0}

        def step_fn(state, step):
            calls["n"] += 1
            if step == 7 and calls["n"] == 8:    # fail once at step 7
                raise RuntimeError("simulated node failure")
            return {"x": add(state["x"], step)}
        return step_fn

    state, log = run_with_recovery(
        make_step(lambda x, s: x + float(s + 1)), {"x": torch.zeros(())},
        n_steps=10, ckpt_dir=str(tmp_path / "t"), ckpt_every=5)
    r_state, r_log = r_run_with_recovery(
        make_step(lambda x, s: x + float(s + 1)), {"x": jnp.zeros(())},
        n_steps=10, ckpt_dir=str(tmp_path / "r"), ckpt_every=5)
    assert log == r_log and log["restarts"] == 1
    assert float(state["x"]) == float(r_state["x"]) == 55.0
    assert ckpt.latest_step(str(tmp_path / "t")) == 10
    with pytest.raises(RuntimeError, match="simulated"):
        run_with_recovery(_always_fails, {"x": torch.zeros(())}, n_steps=3,
                          ckpt_dir=str(tmp_path / "f"), max_restarts=2)


def _always_fails(state, step):
    raise RuntimeError("simulated node failure")


def test_elastic_restore_resharding(tmp_path):
    """A checkpoint restores onto another placement: every leaf where the
    placement tree over the mesh's devices puts it."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(8, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 3, tree)
    mesh = make_mesh((2,), ("batch",), devices=["cpu", "cpu"])

    def placements(template, m):
        return {"w": m.devices.flat[0], "b": m.devices.flat[1]}

    restored, step = elastic_restore(str(tmp_path), tree, mesh, placements)
    assert step == 3
    for k in tree:
        assert torch.equal(restored[k], tree[k])
        assert restored[k].device == torch.device("cpu")
    restored, _ = elastic_restore(str(tmp_path), tree, None, placements,
                                  device="cpu")
    assert torch.equal(restored["w"], tree["w"])


def test_async_checkpoint(tmp_path):
    """``blocking=False`` returns the writer thread; the leaves were copied
    to the host before it started, so a later in-place update does not
    reach the checkpoint."""
    tree = {"a": torch.ones((128, 128))}
    t = ckpt.save(str(tmp_path), 1, tree, blocking=False)
    tree["a"].add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    restored, step = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert step == 1
    assert torch.equal(restored["a"], torch.ones((128, 128)))


def test_straggler_detection():
    mon = HeartbeatMonitor(n_workers=8, window=8, zscore_threshold=3.0)
    for step in range(8):
        for w in range(8):
            mon.report(w, 1.0 + (5.0 if w == 3 else 0.0), now=float(step))
    assert mon.stragglers() == [3]
    assert mon.dead(now=1000.0) == list(range(8))


def test_checkpoint_refusals(tmp_path):
    """A leaf numpy cannot hold is named, not upcast (bfloat16 is saved as
    the reference saves it: ``tests/test_torch_repairs.py``, F4); a missing
    checkpoint and a placement tree of the wrong size raise; without
    ``device`` a CPU-only host raises as ``resolve_device`` does."""
    fp8 = {"h": [torch.zeros(2), torch.zeros(2, dtype=torch.float8_e4m3fn)]}
    with pytest.raises(TypeError, match="'h/1'.*float8_e4m3fn"):
        ckpt.save(str(tmp_path / "fp8"), 1, fp8)
    bf16 = {"h": [torch.zeros(2), torch.ones(2, dtype=torch.bfloat16)]}
    ckpt.save(str(tmp_path / "bf16"), 1, bf16)
    got, _ = ckpt.restore(str(tmp_path / "bf16"), bf16, device="cpu")
    assert torch.equal(got["h"][1], bf16["h"][1])
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"a": torch.zeros(1)},
                     device="cpu")
    tree = {"a": torch.zeros(2), "b": torch.zeros(3)}
    ckpt.save(str(tmp_path), 2, tree)
    with pytest.raises(ValueError, match="shardings has 1 leaves"):
        ckpt.restore(str(tmp_path), tree, shardings={"a": None})
    got, _ = ckpt.restore(str(tmp_path), tree, device="cpu",
                          shardings={"a": torch.device("cpu"), "b": None})
    assert torch.equal(got["b"], tree["b"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ckpt.restore(str(tmp_path), tree)
