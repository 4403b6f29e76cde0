"""The port's training path against the reference, on the CPU.

``cross_entropy``: value and gradient against ``jax.value_and_grad`` of
the reference's, within ``1e-6`` relative in fp32 and ``1e-3`` on bf16
logits (the gradient relative to its largest element), in one chunk of
rows and in several. The train step on reduced minitron-8b (fp32, batch 2)
with the reference's parameters carried across (``params_from_numpy``),
at seq 16 (the einsum attention) and 2048 (the scan): loss within
``1e-5`` relative, ``grad_norm`` within ``1e-4``, every gradient leaf
within ``1e-5 * max|g|``, and three AdamW steps' losses within ``1e-4``.
Remat on and off give ``torch.equal`` gradients. ``launch.train.train``
interrupted and resumed from its checkpoint gives the uninterrupted run's
losses exactly; its CLI runs to its end; without a card and without
``device`` it raises.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.train import steps as r_steps  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, BATCH, N_STEPS = "minitron-8b", 2, 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [None, 3], ids=["one_chunk", "chunks_of_3"])
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-6), ("bfloat16", 1e-3)])
def test_cross_entropy_matches_reference(monkeypatch, dtype, rel, rows):
    b, s, v = 2, 7, 300
    if rows is not None:
        monkeypatch.setattr(steps, "CE_CHUNK", rows * v)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((b, s, v)) * 4).astype(np.float32)
    t = rng.integers(0, v, (b, s)).astype(np.int32)
    r_loss, r_grad = jax.value_and_grad(r_steps.cross_entropy)(
        jnp.asarray(x).astype(dtype), jnp.asarray(t))
    logits = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss = steps.cross_entropy(logits, torch.from_numpy(t))
    (grad,) = torch.autograd.grad(loss, logits)
    assert loss.dtype == torch.float32 and grad.dtype == logits.dtype
    assert _rel(float(loss.detach()), float(r_loss)) <= rel
    r_grad = np.asarray(r_grad.astype(jnp.float32))
    err = np.abs(grad.float().numpy() - r_grad).max()
    assert err <= rel * np.abs(r_grad).max(), err


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(seq: int):
    """The reference's reduced minitron-8b at ``seq``: float32 numpy
    params, step 0's batch, loss, gradients (by key) and grad norm, and
    the losses of N_STEPS jitted train steps."""
    cfg = r_get_config(ARCH).reduced()
    params = r_steps.init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    data = DataConfig(cfg.vocab_size, seq, BATCH)
    batch = batch_for_step(data, 0)

    def loss_fn(p, b):
        return r_steps.cross_entropy(r_steps.forward_logits(p, b, cfg),
                                     b["targets"])
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jax.tree.map(jnp.asarray, batch))
    flat = {_key(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    step = jax.jit(r_steps.make_train_step(cfg, r_adamw.AdamWConfig(**OPT)))
    state, losses = r_adamw.init(params), []
    for i in range(N_STEPS):
        params, state, m = step(params, state, jax.tree.map(
            jnp.asarray, batch_for_step(data, i)))
        losses.append(float(m["loss"]))
    return (np_params, batch, float(loss), flat,
            float(r_adamw.global_norm(grads)), losses)


@pytest.mark.parametrize("seq", [16, 2048])
def test_train_step_gradients_match_reference(seq):
    np_params, batch, r_loss, r_grads, r_norm, _ = _reference(seq)
    cfg = get_config(ARCH).reduced()
    params = transformer.params_from_numpy(np_params, cfg, "cpu")
    loss, grads = steps.loss_and_grads(params, batch, cfg)
    assert _rel(float(loss), r_loss) <= 1e-5
    assert _rel(float(adamw.global_norm(grads)), r_norm) <= 1e-4
    flat = {_key(p): g.numpy()
            for p, g in pytree.tree_flatten_with_path(grads)[0]}
    assert flat.keys() == r_grads.keys()
    for k, g in r_grads.items():
        assert flat[k].shape == g.shape, k
        err = np.abs(flat[k] - g).max()
        assert err <= 1e-5 * np.abs(g).max(), (k, err)


@pytest.mark.parametrize("seq", [16, 2048])
def test_train_step_trajectory_matches_reference(seq):
    """Three train steps from the same parameters and batches: each loss
    within 1e-4 relative; the step updates the params and state in place
    and reports grad_norm and lr as float32 tensors."""
    np_params, _, _, _, _, r_losses = _reference(seq)
    cfg = get_config(ARCH).reduced()
    params = transformer.params_from_numpy(np_params, cfg, "cpu")
    state = adamw.init(params)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))
    ptrs = [p.data_ptr() for p in pytree.tree_leaves((params, state))]
    data = DataConfig(cfg.vocab_size, seq, BATCH)
    for i, r_loss in enumerate(r_losses):
        out, out_state, m = step(params, state, batch_for_step(data, i))
        assert out is params and out_state is state
        assert _rel(float(m["loss"]), r_loss) <= 1e-4, (i, m["loss"], r_loss)
        assert m["grad_norm"].dtype == m["lr"].dtype == torch.float32
    assert [p.data_ptr() for p in pytree.tree_leaves((params, state))] == ptrs
    assert int(state["step"]) == N_STEPS


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_gives_the_same_gradients(monkeypatch, policy):
    """``remat`` recomputes each group in the backward (every layer runs
    twice) and changes no gradient bit; "dots" keeps the matmuls without
    batch dimensions (no ``mm`` runs again), "none" recomputes them too;
    without grad nothing is wrapped."""
    base = get_config(ARCH).reduced()
    params = steps.init_params(base, torch.Generator().manual_seed(0), "cpu")
    batch = batch_for_step(DataConfig(base.vocab_size, 16, BATCH), 0)
    calls = []
    apply_layer = transformer.apply_layer

    def counting(*args, **kwargs):
        calls.append(1)
        return apply_layer(*args, **kwargs)
    monkeypatch.setattr(transformer, "apply_layer", counting)
    runs, mm = {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        calls.clear()
        with _CountMatmuls() as count:
            runs[remat] = steps.loss_and_grads(params, batch, cfg)
        mm[remat] = count.mm
        assert len(calls) == base.n_layers * (2 if remat else 1)
    assert (mm[True] == mm[False]) == (policy == "dots")
    assert torch.equal(runs[False][0], runs[True][0])
    for a, b in zip(pytree.tree_leaves(runs[False][1]),
                    pytree.tree_leaves(runs[True][1])):
        assert torch.equal(a, b)
    calls.clear()
    with torch.no_grad():
        steps.forward_logits(params, {"tokens": torch.from_numpy(
            batch["tokens"])}, dataclasses.replace(base, remat=True))
    assert len(calls) == base.n_layers


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_resumed_training_gives_the_uninterrupted_losses(tmp_path):
    """20 steps in one run, against 10 steps (the same schedule horizon)
    then a second run that resumes from the step-10 checkpoint."""
    kw = dict(device="cpu", log_every=100)
    full = train_mod.train(ARCH, steps=20, ckpt_dir=str(tmp_path / "a"), **kw)
    first = train_mod.train(ARCH, steps=10, total_steps=20,
                            ckpt_dir=str(tmp_path / "b"), **kw)
    rest = train_mod.train(ARCH, steps=20, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(full) == 20 and first == full[:10] and rest == full[10:]
    assert full[-1] < full[0] and np.isfinite(full).all()


def test_train_cli_runs_to_its_end(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--ckpt-dir", str(tmp_path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "final loss" in out.stdout and "step    19" in out.stdout
    assert (tmp_path / "LATEST").read_text() == "step_00000020"


def test_train_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.train(ARCH, steps=1)


def test_build_refuses_a_mesh_of_several_positions():
    """Over several positions ``build`` gives the mesh step, which refuses
    a batch that does not split evenly over the data positions."""
    cfg = get_config(ARCH).reduced()
    opt = adamw.AdamWConfig(**OPT)
    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"])
    params, state, step_fn, _ = train_mod.build(cfg, opt, mesh)
    batch = batch_for_step(DataConfig(cfg.vocab_size, 8, 3), 0)
    with pytest.raises(ValueError, match="does not split evenly"):
        step_fn(params, state, batch)
    params, state, step_fn, rules = train_mod.build(
        cfg, opt, make_mesh((1, 1), ("data", "model"), device_type="cpu"))
    assert rules.mesh.size == 1 and int(state["step"]) == 0
    assert params["embed"].device == torch.device("cpu")
