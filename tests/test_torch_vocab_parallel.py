"""The cross-entropy over the ``model`` positions' vocabulary shares of the
logits (``train.steps.cross_entropy`` given a list, the training path of
every split family), on the CPU.

* Against the reference's ``cross_entropy`` and its ``jax.grad`` on the
  same seeded numpy logits, cut into 1, 2, 3 (uneven) and 16 vocabulary
  shares, in fp32 and bf16, in one chunk of rows and in chunks of 3;
  targets drawn over the whole vocabulary, and all inside the first share
  (every other share holds no gold logit): the loss within 1e-6 relative
  in fp32 (bf16: 1e-3, the gathered loss's own limit in
  ``tests/test_torch_train.py``), the gradient within 1e-6 of max|g| in
  fp32 and, in bf16, each element within one bf16 step of the
  reference's.
* One share is the loss over the gathered logits as it stood before the
  split (its copy here), bit for bit, value and gradient.
* A split step of each family, counted: its loss reads the shares where
  they lie, so no collective it declares, forward or backward, is as
  large as a (B, S, V_i) share; every position declares the loss's three
  all-reduces of (N,) rows.
  (A split dry-run train cell holds no logits on position 0 either:
  ``tests/test_torch_dryrun.py``.)
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import steps as r_steps  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import steps  # noqa: E402

V, ROWS, SEQ = 300, 2, 7
SHARES = {1: [0, V], 2: [0, 150, V], 3: [0, 97, 200, V],
          16: [i * V // 16 for i in range(17)]}


class _Gathered(torch.autograd.Function):
    """The cross-entropy over the whole (N, V) logits as it stood before
    the split (one share must equal it bit for bit)."""

    @staticmethod
    def forward(ctx, logits, targets):
        n, v = logits.shape
        rows = max(1, steps.CE_CHUNK // v)
        m = torch.empty(n, dtype=logits.dtype)
        sumexp = torch.empty(n, dtype=torch.float32)
        for i in range(0, n, rows):
            x = logits[i:i + rows]
            m[i:i + rows] = x.amax(-1)
            shifted = (x - m[i:i + rows, None]).float()
            sumexp[i:i + rows] = torch.exp(shifted).sum(-1)
        lse = torch.log(sumexp) + m.float()
        gold = logits.gather(1, targets[:, None])[:, 0].float()
        ctx.save_for_backward(logits, targets, m, sumexp)
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, grad):
        logits, targets, m, sumexp = ctx.saved_tensors
        n, v = logits.shape
        rows = max(1, steps.CE_CHUNK // v)
        ct = grad.float() / n
        row_ct = ct / sumexp
        out = torch.empty_like(logits)
        for i in range(0, n, rows):
            shifted = (logits[i:i + rows] - m[i:i + rows, None]).float()
            out[i:i + rows] = torch.exp(shifted).mul_(row_ct[i:i + rows,
                                                             None])
        idx = torch.arange(n)
        out[idx, targets] = out[idx, targets] + (-ct).to(out.dtype)
        return out, None


def _logits(seed, gold_in_first):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((ROWS, SEQ, V)) * 4).astype(np.float32)
    hi = V // 16 if gold_in_first else V    # inside share 0 of any cut
    t = rng.integers(0, hi, (ROWS, SEQ)).astype(np.int32)
    return x, t


def _split_loss(x, t, cuts, dtype):
    whole = torch.from_numpy(x).to(dtype)
    shares = [whole[..., a:b].clone().requires_grad_()
              for a, b in zip(cuts, cuts[1:])]
    loss = steps.cross_entropy(shares, torch.from_numpy(t))
    grads = torch.autograd.grad(loss, shares)
    return loss.detach(), torch.cat(grads, -1)


def _bf16_step(r: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at each element of ``r`` (its 8 bits of
    significand), the smallest normal's at 0."""
    mag = np.maximum(np.abs(r), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("rows", [None, 3], ids=["one_chunk", "chunks_of_3"])
@pytest.mark.parametrize("gold_in_first", [False, True],
                         ids=["targets_anywhere", "targets_in_share_0"])
@pytest.mark.parametrize("n_shares", sorted(SHARES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_loss_matches_the_reference(monkeypatch, dtype, n_shares,
                                          gold_in_first, rows):
    if rows is not None:
        monkeypatch.setattr(steps, "CE_CHUNK", rows * V)
    x, t = _logits(n_shares, gold_in_first)
    r_loss, r_grad = jax.value_and_grad(r_steps.cross_entropy)(
        jnp.asarray(x).astype(dtype), jnp.asarray(t))
    loss, grad = _split_loss(x, t, SHARES[n_shares], getattr(torch, dtype))
    assert loss.dtype == torch.float32 and grad.dtype == getattr(torch,
                                                                 dtype)
    rel = 1e-6 if dtype == "float32" else 1e-3
    assert abs(float(loss) - float(r_loss)) <= rel * abs(float(r_loss))
    r_grad = np.asarray(r_grad.astype(jnp.float32))
    err = np.abs(grad.float().numpy() - r_grad)
    if dtype == "float32":
        assert err.max() <= 1e-6 * np.abs(r_grad).max(), err.max()
    else:
        assert bool((err <= _bf16_step(r_grad)).all()), err.max()


@pytest.mark.parametrize("rows", [None, 3], ids=["one_chunk", "chunks_of_3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_share_is_the_gathered_loss_bit_for_bit(monkeypatch, dtype,
                                                    rows):
    if rows is not None:
        monkeypatch.setattr(steps, "CE_CHUNK", rows * V)
    x, t = _logits(5, False)
    logits = torch.from_numpy(x).to(getattr(torch, dtype))
    a = logits.clone().requires_grad_()
    want = _Gathered.apply(a.reshape(-1, V),
                           torch.from_numpy(t).reshape(-1).long())
    (want_g,) = torch.autograd.grad(want, a)
    for given in (logits, [logits]):
        b = (given if isinstance(given, torch.Tensor) else given[0]) \
            .clone().requires_grad_()
        got = steps.cross_entropy(b if isinstance(given, torch.Tensor)
                                  else [b], torch.from_numpy(t))
        (got_g,) = torch.autograd.grad(got, b)
        assert torch.equal(got, want) and torch.equal(got_g, want_g)


FAMILY_ARCHS = ["minitron-8b", "llama4-scout-17b-16e",
                "llama-3.2-vision-11b", "mamba2-130m", "zamba2-7b",
                "whisper-base"]


@pytest.mark.parametrize("positions", [2, 4])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_split_step_gathers_no_logits(monkeypatch, arch, positions):
    """``loss_and_grads`` of a placed reduced tree over (1, positions),
    counted, with every declared collective recorded: none, forward or
    backward, is as large as a position's (B, S, V_i) share of the
    logits (whisper's head is a master copy, cut per position: its cut of
    (d, V_i) columns is smaller than the share at 128 rows); each
    position declares the three all-reduces of the loss's (N,) rows (the
    float32 row max and gold logit, the float64 sum) and the loss equals
    the unsplit tree's within 1e-6."""
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=False)
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(cfg, n_layers=5)
    rows, seq = 4, 32
    n = rows * seq
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rules = sharding.make_rules(make_mesh(
        (1, positions), ("data", "model"), devices=["cpu"] * positions))
    placed = steps.place(cfg, params, rules)
    batch = batch_for_step(DataConfig(cfg.vocab_size, seq, rows), 0)
    batch.update(train_mod.extras_for(cfg, rows, np.random.default_rng(1)))
    seen, declare = [], rl.declare_collective

    def record(kind, nbytes, counters=None, device=None):
        seen.append((kind, nbytes, str(device)))
        return declare(kind, nbytes, counters, device)
    monkeypatch.setattr(rl, "declare_collective", record)
    (loss, _), _ = rl.count(steps.loss_and_grads, placed, batch, cfg)
    share = n * (cfg.vocab_size // positions) * 4
    assert seen and max(b for _, b, _ in seen) < share
    reduces = [b for k, b, _ in seen if k == "all-reduce"]
    assert reduces.count(n * 8) == positions
    assert reduces.count(n * 4) >= 2 * positions
    want, _ = steps.loss_and_grads(params, batch, cfg)
    assert abs(float(loss) - float(want)) <= 1e-6 * float(want)
