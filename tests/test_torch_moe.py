"""The port's MoE FFN against the reference's, on the CPU.

``layers.moe`` (top-1 token-choice routing, per-row capacity, sort-based
dispatch, shared expert) and ``layers.moe_ref`` (the dense per-expert
oracle) on reduced llama4-scout-17b-16e (4 experts, a shared expert) and
llama4-maverick-400b-a17b, in fp32, every leaf of the reference's
``init_moe`` tree drawn anew from numpy: first the expert assignment
equals ``jnp.argmax``'s (so no near tie decides the comparison), then the
output is within ``2e-4 * max(1, max|out|)`` of the reference's, once
with capacity drops (capacity factor 0.5) and once without (64). In bf16
the router stays float32 through ``init_params`` and
``params_from_numpy``. Prefill and one decode step equal the forward's
last-token logits at capacity factor 64, as the reference's
``test_decode_matches_forward``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.train import steps as r_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCHS = ["llama4-scout-17b-16e", "llama4-maverick-400b-a17b"]
REL = 2e-4


def _cfgs(arch, capacity_factor=None):
    r_cfg, cfg = r_get_config(arch).reduced(), get_config(arch).reduced()
    if capacity_factor is not None:
        r_cfg = dataclasses.replace(r_cfg, capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return r_cfg, cfg


def _drawn(tree, seed):
    """Every leaf of ``tree`` drawn anew from numpy with its spread."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a, np.float32)
        return rng.standard_normal(a.shape).astype(np.float32) * a.std()
    return jax.tree.map(draw, tree)


def _moe_inputs(arch, capacity_factor, s=64):
    r_cfg, cfg = _cfgs(arch, capacity_factor)
    np_p = _drawn(r_layers.init_moe(jax.random.PRNGKey(1), r_cfg,
                                    jnp.float32), seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    return r_cfg, cfg, np_p, x


def _close(out, ref):
    ref = np.asarray(ref)
    tol = REL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out.numpy() - ref).max())
    assert out.shape == ref.shape and err <= tol, (err, tol)


@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True),
                                                   (64.0, False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(arch, capacity_factor, drops):
    r_cfg, cfg, np_p, x = _moe_inputs(arch, capacity_factor)
    p = layers.params_from_numpy(np_p, cfg, "cpu")
    r_p = jax.tree.map(jnp.asarray, np_p)
    # the routing: the port's float32 router logits pick the experts
    # jnp.argmax picks
    idx = (torch.from_numpy(x).float() @ p["router"]).argmax(-1).numpy()
    r_idx = np.asarray(jnp.argmax(jnp.asarray(x) @ r_p["router"], -1))
    np.testing.assert_array_equal(idx, r_idx)
    s, e = x.shape[1], cfg.n_experts
    cap = max(1, int(capacity_factor * s / e) + 1)
    counts = np.stack([np.bincount(row, minlength=e) for row in idx])
    assert bool((counts > cap).any()) == drops
    _close(layers.moe(p, torch.from_numpy(x), cfg),
           r_layers.moe(r_p, jnp.asarray(x), r_cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ref_matches_reference(arch):
    r_cfg, cfg, np_p, x = _moe_inputs(arch, None)
    p = layers.params_from_numpy(np_p, cfg, "cpu")
    ref = r_layers.moe_ref(jax.tree.map(jnp.asarray, np_p), jnp.asarray(x),
                           r_cfg)
    _close(layers.moe_ref(p, torch.from_numpy(x), cfg), ref)
    # without drops the routed path is the oracle
    big = dataclasses.replace(cfg, capacity_factor=64.0)
    _close(layers.moe(p, torch.from_numpy(x), big), ref)


def test_router_stays_float32_in_bf16():
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="bfloat16")
        params = steps.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        slots = [slot["moe"] for slot in params["layers"] if "moe" in slot]
        assert slots and all(m["router"].dtype == torch.float32
                             and m["we_gate"].dtype == torch.bfloat16
                             for m in slots)
        r_cfg = dataclasses.replace(r_get_config(arch).reduced(),
                                    dtype="bfloat16")
        ref = jax.eval_shape(lambda k: r_steps.init_params(k, r_cfg),
                             jax.random.PRNGKey(0))
        carried = steps.params_from_numpy(
            jax.tree.map(lambda a: np.zeros(a.shape, np.float32), ref),
            cfg, "cpu")
        for slot, r_slot in zip(carried["layers"], ref["layers"]):
            if "moe" in slot:
                assert slot["moe"]["router"].dtype == torch.float32
                assert str(r_slot["moe"]["router"].dtype) == "float32"
                assert slot["moe"]["we_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """At capacity factor 64 no token overflows, so prefill and one decode
    step give the forward's last-token logits (the reference's test, with
    its tolerance)."""
    _, cfg = _cfgs(arch, 64.0)
    cfg = dataclasses.replace(cfg, remat=False)
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8),
                                           dtype=np.int32))
    prefill, decode = steps.make_serve_steps(cfg)
    cache = steps.init_cache(cfg, 2, 12, "cpu")
    with torch.no_grad():
        fwd = steps.forward_logits(params, {"tokens": tokens}, cfg)
        lg, cache = prefill(params, tokens, cache)
        np.testing.assert_allclose(lg.numpy(), fwd[:, -1].numpy(),
                                   rtol=2e-3, atol=2e-3)
        nxt = lg.argmax(-1)[:, None].int()
        lg2, _ = decode(params, nxt, cache, 8)
        fwd2 = steps.forward_logits(
            params, {"tokens": torch.cat([tokens, nxt], 1)}, cfg)
        np.testing.assert_allclose(lg2.numpy(), fwd2[:, -1].numpy(),
                                   rtol=2e-3, atol=2e-3)
