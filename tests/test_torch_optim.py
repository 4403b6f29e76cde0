"""The port's optimizer numerics against the reference: AdamW (schedule,
global norm, the in-place update over steps that cross the warmup and the
horizon, weight decay on every leaf with ``ndim >= 2``) within ``1e-6``
of each leaf's largest element; the int8 gradient compression
(``compress_grad`` q and scale bit for bit, the error within one float32
ulp; error feedback telescopes); ``compressed_psum`` over 8 replicas
(``torch.distributed`` processes on ``gloo``) against the reference's
``shard_map`` run over 8 forced host devices, within ``1e-6``."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as r_adamw  # noqa: E402
from repro.optim import compression as r_comp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(lr=1e-2, warmup_steps=3, total_steps=6)


def _tree(rng):
    """A params-shaped tree: matrices, a stacked (n_groups, d) norm (ndim 2:
    decayed, as in the reference) and plain vectors (not decayed)."""
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "final_norm": rng.standard_normal(8).astype(np.float32),
            "layers": [{
                "w": rng.standard_normal((2, 8, 8)).astype(np.float32),
                "norm": rng.standard_normal((2, 8)).astype(np.float32)}],
            "scale": rng.standard_normal(()).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree(t_tree, r_tree, rtol=1e-6):
    """Each leaf within ``rtol`` of its largest reference element: the
    global norm sums in another order (one float32 ulp), and ``m`` near a
    cancellation carries that ulp as a larger share of a small element."""
    t_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), t_tree))
    r_leaves = jax.tree.leaves(r_tree)
    assert len(t_leaves) == len(r_leaves)
    for t, r in zip(t_leaves, r_leaves):
        r = np.asarray(r)
        np.testing.assert_allclose(t, r, rtol=0,
                                   atol=rtol * float(np.abs(r).max()))


def test_schedule_matches_reference():
    for cfg_kw in (OPT, {}, dict(warmup_steps=0, total_steps=1)):
        cfg, r_cfg = adamw.AdamWConfig(**cfg_kw), r_adamw.AdamWConfig(**cfg_kw)
        for step in range(0, 12):
            lr = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
            r_lr = r_adamw.schedule(r_cfg, jnp.int32(step))
            assert lr.dtype == torch.float32
            np.testing.assert_allclose(lr.numpy(), np.asarray(r_lr),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("chunk", [adamw.CHUNK, 5])
def test_adamw_update_matches_reference(monkeypatch, chunk):
    """Eight steps with clipped and unclipped gradients across warmup (3)
    and the horizon (6): params, m, v, grad_norm and lr each step; the
    port updates in place (the same tensors come back), in chunks of
    ``chunk`` elements."""
    monkeypatch.setattr(adamw, "CHUNK", chunk)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg, r_cfg = adamw.AdamWConfig(**OPT), r_adamw.AdamWConfig(**OPT)
    t_params = _to_torch(params)
    t_state = adamw.init(t_params)
    r_params = jax.tree.map(jnp.asarray, params)
    r_state = r_adamw.init(r_params)
    before = [p.data_ptr() for p in jax.tree.leaves(t_params)]
    for step in range(8):
        size = 0.01 if step % 2 else 1.0      # clipped on the even steps
        grads = jax.tree.map(
            lambda a: (size * rng.standard_normal(a.shape)).astype(np.float32),
            params)
        t_params, t_state, tm = adamw.update(cfg, _to_torch(grads), t_state,
                                             t_params)
        r_params, r_state, rm = r_adamw.update(
            r_cfg, jax.tree.map(jnp.asarray, grads), r_state, r_params)
        _assert_tree(t_params, r_params)
        _assert_tree(t_state["m"], r_state["m"])
        _assert_tree(t_state["v"], r_state["v"])
        assert int(t_state["step"]) == int(r_state["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(rm[k]),
                                       rtol=1e-6, atol=0)
    assert [p.data_ptr() for p in jax.tree.leaves(t_params)] == before


def test_weight_decay_reaches_the_reference_leaves():
    """With zero gradients only the decay moves a leaf: every leaf of
    ``ndim >= 2`` (the stacked norm too) shrinks, the vectors and the
    scalar stay, as in the reference."""
    params = _tree(np.random.default_rng(1))
    zeros = jax.tree.map(np.zeros_like, params)
    t_params = _to_torch(params)
    cfg = adamw.AdamWConfig(**OPT)
    t_params, _, _ = adamw.update(cfg, _to_torch(zeros), adamw.init(t_params),
                                  t_params)
    r_params, _, _ = r_adamw.update(
        r_adamw.AdamWConfig(**OPT), jax.tree.map(jnp.asarray, zeros),
        r_adamw.init(jax.tree.map(jnp.asarray, params)),
        jax.tree.map(jnp.asarray, params))
    _assert_tree(t_params, r_params)
    moved = jax.tree.map(lambda t, a: bool((t.numpy() != a).any()),
                         t_params, params)
    assert moved == {"embed": True, "final_norm": False, "scale": False,
                     "layers": [{"w": True, "norm": True}]}


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(2))
    np.testing.assert_allclose(
        adamw.global_norm(_to_torch(tree)).numpy(),
        np.asarray(r_adamw.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_grad_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((33, 17)) * 10 ** seed).astype(np.float32)
    err = (rng.standard_normal((33, 17)) * 0.01).astype(np.float32)
    q, scale, new_err = comp.compress_grad(torch.from_numpy(g),
                                           torch.from_numpy(err))
    r_q, r_scale, r_err = r_comp.compress_grad(jnp.asarray(g),
                                               jnp.asarray(err))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(r_q))
    assert scale.numpy().tobytes() == np.asarray(r_scale).tobytes()
    r_err = np.asarray(r_err)
    ulp = np.spacing(np.abs(r_err).astype(np.float32))
    assert (np.abs(new_err.numpy() - r_err) <= ulp).all()
    # the tensor path and the numpy path of quantize_int8 agree bit for bit
    qt, st = comp.quantize_int8(torch.from_numpy(g))
    qn, sn = comp.quantize_int8(g)
    np.testing.assert_array_equal(qt.numpy(), qn)
    assert st.numpy().tobytes() == np.float32(sn).tobytes()
    np.testing.assert_array_equal(comp.dequantize_int8(qt, st).numpy(),
                                  comp.dequantize_int8(qn, sn))
    zeros = comp.init_error_state({"a": torch.from_numpy(g)})
    assert torch.equal(zeros["a"], torch.zeros(33, 17))


@pytest.mark.parametrize("seed,steps", [(0, 1), (3, 4), (7, 8)])
def test_error_feedback_telescopes(seed, steps):
    """sum(decoded_t) + err_T == sum(g_t): no information is lost (the
    reference's property, tests/test_properties.py)."""
    rng = np.random.default_rng(seed)
    err = torch.zeros(32)
    total_g, total_dec = torch.zeros(32), torch.zeros(32)
    for _ in range(steps):
        g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        q, scale, err = comp.compress_grad(g, err)
        total_g += g
        total_dec += comp.dequantize_int8(q, scale)
    np.testing.assert_allclose((total_dec + err).numpy(), total_g.numpy(),
                               rtol=1e-4, atol=1e-4)


_N_REPLICAS = 8

_REF_PSUM = """
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.optim.compression import compressed_psum
    d = np.load({inp!r})
    mesh = make_mesh((8,), ("data",))

    def body(w, b, ew, eb):
        mean, err = compressed_psum({{"w": w[0], "b": b[0]}},
                                    {{"w": ew[0], "b": eb[0]}}, ("data",))
        return mean["w"], mean["b"], err["w"][None], err["b"][None]

    outs = shard_map(body, mesh=mesh, in_specs=(P("data"),) * 4,
                     out_specs=(P(), P(), P("data"), P("data")))(
        *(jnp.asarray(d[k]) for k in ("w", "b", "ew", "eb")))
    np.savez({out!r}, **dict(zip(("w", "b", "ew", "eb"),
                                 (np.asarray(o) for o in outs))))
"""

_PORT_PSUM = """
    import sys, numpy as np, torch, torch.distributed as dist
    from repro_torch.optim.compression import compressed_psum
    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method="file://{rdv}", rank=rank,
                            world_size=8)
    d = np.load({inp!r})
    t = {{k: torch.from_numpy(d[k][rank]) for k in ("w", "b", "ew", "eb")}}
    mean, err = compressed_psum({{"w": t["w"], "b": t["b"]}},
                                {{"w": t["ew"], "b": t["eb"]}})
    np.savez({out!r}.format(rank), w=mean["w"].numpy(), b=mean["b"].numpy(),
             ew=err["w"].numpy(), eb=err["b"].numpy())
    dist.destroy_process_group()
"""


def test_compressed_psum_matches_reference_over_8_replicas(tmp_path):
    """Each of 8 replicas holds its own gradients and error state; the
    port's replicas are ``torch.distributed`` processes, the reference's
    the positions of a ``shard_map`` over 8 forced host devices. The mean
    (the same on every replica) and each replica's new error agree within
    ``1e-6``."""
    rng = np.random.default_rng(0)
    inp = str(tmp_path / "in.npz")
    np.savez(inp, w=rng.standard_normal((8, 16, 4)).astype(np.float32),
             b=(rng.standard_normal((8, 5)) * 3).astype(np.float32),
             ew=(rng.standard_normal((8, 16, 4)) * 0.01).astype(np.float32),
             eb=(rng.standard_normal((8, 5)) * 0.01).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo")
    ref_out, port_out = str(tmp_path / "ref.npz"), str(tmp_path / "p{}.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF_PSUM).format(
            inp=inp, out=ref_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]
    code = textwrap.dedent(_PORT_PSUM).format(
        rdv=str(tmp_path / "rdv"), inp=inp, out=port_out)
    procs += [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(_N_REPLICAS)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    ref = np.load(ref_out)
    d = np.load(inp)
    for r in range(_N_REPLICAS):
        got = np.load(port_out.format(r))
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got[k], d[k].mean(0), atol=0.05)
            np.testing.assert_allclose(got["e" + k], ref["e" + k][r],
                                       rtol=1e-6, atol=1e-6)
