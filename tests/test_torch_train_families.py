"""Training of the MoE, SSM, hybrid, audio and VLM families against the
reference, on the CPU.

Reduced llama4-scout-17b-16e, mamba2-130m, zamba2-7b, whisper-base and
llama-3.2-vision-11b in fp32, batch 2 x 16, every parameter leaf drawn
from numpy (``test_torch_families._drawn_params``) and carried to both
packages, the frames and image embeddings drawn from numpy too:
``loss_and_grads`` against ``jax.value_and_grad`` of the reference's loss
(loss within ``1e-5`` relative, every gradient leaf within
``1e-5 * max|g|``), and three AdamW steps' losses within ``1e-4``. Remat
on and off give ``torch.equal`` gradients for mamba2 (per layer), zamba2
(per group; its tail unwrapped) and whisper (per decoder layer; the
encoder unwrapped). ``launch.train.train`` runs each family on the CPU.
"""
import dataclasses
import functools

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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import mamba2, whisper, zamba2  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from test_torch_families import _drawn_params  # noqa: E402

ARCHS = ["llama4-scout-17b-16e", "mamba2-130m", "zamba2-7b", "whisper-base",
         "llama-3.2-vision-11b"]
BATCH, SEQ, N_STEPS = 2, 16, 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _batch(cfg, step: int) -> dict:
    """``batch_for_step``'s tokens and targets, and the stub frontend's
    float32 frames or image embeddings drawn from a numpy generator."""
    b = batch_for_step(DataConfig(cfg.vocab_size, SEQ, BATCH), step)
    rng = np.random.default_rng(100 + step)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (BATCH, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference on reduced ``arch``: the drawn float32 params, step
    0's loss and gradients (by key), and the losses of N_STEPS jitted
    train steps."""
    cfg = r_get_config(arch).reduced()
    np_params = _drawn_params(cfg, seed=7)
    params = jax.tree.map(jnp.asarray, np_params)

    def loss_fn(p, b):
        return r_steps.cross_entropy(r_steps.forward_logits(p, b, cfg),
                                     b["targets"])
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jax.tree.map(jnp.asarray, _batch(cfg, 0)))
    flat = {_key(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    step = jax.jit(r_steps.make_train_step(cfg, r_adamw.AdamWConfig(**OPT)))
    state, losses = r_adamw.init(params), []
    for i in range(N_STEPS):
        params, state, m = step(params, state, jax.tree.map(
            jnp.asarray, _batch(cfg, i)))
        losses.append(float(m["loss"]))
    return np_params, float(loss), flat, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    np_params, r_loss, r_grads, _ = _reference(arch)
    cfg = get_config(arch).reduced()
    params = steps.params_from_numpy(np_params, cfg, "cpu")
    loss, grads = steps.loss_and_grads(params, _batch(cfg, 0), cfg)
    assert _rel(float(loss), r_loss) <= 1e-5
    flat = {_key(p): g.numpy()
            for p, g in pytree.tree_flatten_with_path(grads)[0]}
    assert flat.keys() == r_grads.keys()
    for k, g in r_grads.items():
        assert flat[k].shape == g.shape, k
        err = np.abs(flat[k] - g).max()
        assert err <= 1e-5 * np.abs(g).max(), (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_trajectory_matches_reference(arch):
    np_params, _, _, r_losses = _reference(arch)
    cfg = get_config(arch).reduced()
    params = steps.params_from_numpy(np_params, cfg, "cpu")
    state = adamw.init(params)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT))
    for i, r_loss in enumerate(r_losses):
        params, state, m = step(params, state, _batch(cfg, i))
        assert _rel(float(m["loss"]), r_loss) <= 1e-4, (i, m["loss"], r_loss)
    assert int(state["step"]) == N_STEPS


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


# (arch, n_layers, module and function counted, its calls without remat,
# with remat): zamba2 at 5 layers has two groups of 2 mamba layers (each
# run twice under remat) and a tail of one (once); whisper's 4 decoder
# layers run twice, its encoder once
REMAT_CASES = [
    ("mamba2-130m", None, mamba2, "mamba_block", 4, 8),
    ("zamba2-7b", 5, zamba2, "mamba_block", 5, 9),
    ("whisper-base", None, whisper, "_dec_layer", 4, 8),
]


@pytest.mark.parametrize("policy", ["none", "dots"])
@pytest.mark.parametrize("case", REMAT_CASES, ids=lambda c: c[0])
def test_remat_gives_the_same_gradients(monkeypatch, case, policy):
    """``remat`` recomputes each wrapped unit in the backward and changes
    no gradient bit; "dots" keeps the matmuls without batch dimensions
    (no ``mm`` runs again), "none" recomputes them too; without grad
    nothing is wrapped."""
    arch, n_layers, module, name, plain, wrapped = case
    base = get_config(arch).reduced()
    if n_layers is not None:
        base = dataclasses.replace(base, n_layers=n_layers)
    params = steps.init_params(base, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(base, 0)
    calls, fn = [], getattr(module, name)

    def counting(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counting)
    runs, mm = {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        calls.clear()
        with _CountMatmuls() as count:
            runs[remat] = steps.loss_and_grads(params, batch, cfg)
        mm[remat] = count.mm
        assert len(calls) == (wrapped if remat else plain)
    assert (mm[True] == mm[False]) == (policy == "dots")
    assert torch.equal(runs[False][0], runs[True][0])
    for a, b in zip(pytree.tree_leaves(runs[False][1]),
                    pytree.tree_leaves(runs[True][1])):
        assert torch.equal(a, b)
    calls.clear()
    with torch.no_grad():
        steps.forward_logits(params, steps._on_device(batch, "cpu"),
                             dataclasses.replace(base, remat=True))
    assert len(calls) == plain


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_every_family(arch, capsys):
    """The train entry point on the CPU: random parameters, the stub
    frontends' inputs from ``extras_for``, two steps of finite loss."""
    losses = train_mod.train(arch, steps=2, batch=2, seq=16, device="cpu",
                             log_every=1)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "step     1 loss" in capsys.readouterr().out


def test_a_family_without_a_model_raises():
    """The CNN config has no LM module: the dispatch raises ``ValueError``,
    as the reference's does."""
    cfg = get_config("vgg16")
    with pytest.raises(ValueError, match="cnn"):
        steps.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="cnn"):
        steps.make_train_step(cfg, adamw.AdamWConfig())
    with pytest.raises(ValueError, match="cnn"):
        steps.make_serve_steps(cfg)
