"""Guards for repaired port faults, each held against the reference package
on the same inputs:

* the program cache's validation table is LRU-bounded at
  ``validated_maxsize`` (default ``4 * maxsize``), never drops a schedule
  with live entries, and counts ``validated_evictions`` exactly as the
  reference's does (``tests/test_opt_lowering.py``'s sequence, run on both
  packages);
* the serving CLI requires ``--arch`` and defaults ``--batch`` to 4, as the
  reference's does (both ``main()``s driven with their serve functions
  replaced by recorders), and takes ``--mesh none|host`` with the
  reference's default;
* F3: an entry's CUDA graphs follow the live weight sets, so five weight
  sets taking turns on one stream capture once each (the graph table's
  policy, with stub graphs; the card's guard is in
  ``tests/test_torch_gpu.py``);
* F4: bfloat16 checkpoint leaves. A checkpoint the reference writes from
  bf16 leaves restores in the port bit for bit, the port's ``arrays.npz``
  members for the same values are byte-equal to the reference's (its
  ``<V2`` records) with the same manifest, and a bf16 training state saved
  (blocking and async) and restored on the CPU is ``torch.equal``;
* F5: every kernel wrapper raises under autograd (grad mode on and an
  operand that requires grad) instead of returning an output with no
  ``grad_fn``, on the CPU as on the card, and runs under
  ``torch.no_grad()``; so does the LM's long-sequence ``hopper``
  attention;
* F6: ``im2col`` returns contiguous patches for a 1x1 strided conv with
  one output column (a strided view before the repair, which K1's wrapper
  refuses), and ``backend="hopper"`` serves ``resnet18_specs(16, 8)``,
  whose ``s4b1_proj`` is such a conv, within 1e-4 of the reference's
  ``xla`` logits.
"""
import dataclasses
import json
import sys
import types
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as r_api  # noqa: E402
from repro.core import compiler as r_compiler  # noqa: E402
from repro.core.hybrid_conv import ConvSpec as RConvSpec  # noqa: E402
from repro.core.program_cache import ProgramCache as RProgramCache  # noqa: E402
from repro.checkpoint import checkpoint as r_ckpt  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.models import resnet as r_resnet  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec as TConvSpec  # noqa: E402
from repro_torch.core.program_cache import (  # noqa: E402
    ProgramCache as TProgramCache,
)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.checkpoint import checkpoint as t_ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)
from repro_torch.kernels.gemm.int8 import qmm_i8, qmm_ref  # noqa: E402
from repro_torch.kernels.gemm.kernel import bmm_f32, bmm_ref  # noqa: E402
from repro_torch.kernels.spatial_conv.kernel import (  # noqa: E402
    conv_gemm_f32,
    conv_gemm_ref,
    conv_implicit_f32,
    conv_implicit_ref,
)
from repro_torch.kernels.spatial_conv.ops import im2col  # noqa: E402
from repro_torch.kernels.winograd import kernel as wino  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402


def _programs(n: int):
    """``n`` distinct one-layer schedules (output widths 4, 5, ...), the
    same specs and plans compiled by each package."""
    out = {"ref": [], "port": []}
    for k in range(4, 4 + n):
        for pkg, compiler, spec in (("ref", r_compiler, RConvSpec),
                                    ("port", t_compiler, TConvSpec)):
            specs = [spec("c1", 12, 12, 3, k, padding="SAME", relu=True)]
            out[pkg].append(compiler.compile_network(
                specs, [compiler.LayerPlan("spat", "is", 2, 1, 1)]))
    return out


def _cache_state(cache) -> tuple:
    s = cache.stats
    return (len(cache), cache.validated_size, s.evictions,
            s.validated_evictions, s.hits, s.misses)


def test_validated_table_bounded_like_reference():
    """The reference's sequence (``tests/test_opt_lowering.py``,
    ``test_validated_table_bounded_with_eviction_stats``): 8 distinct
    programs through ``get`` on ``ProgramCache(maxsize=2,
    validated_maxsize=3)``, then a re-validate of the newest (a live
    schedule: a hit, nothing evicted)."""
    progs = _programs(8)
    ref = RProgramCache(maxsize=2, validated_maxsize=3)
    port = TProgramCache(maxsize=2, validated_maxsize=3)
    for rp, tp in zip(progs["ref"], progs["port"]):
        ref.get(rp, batch=1, dtype=jnp.float32)
        port.get(tp, batch=1, dtype=torch.float32, device="cpu")
        assert _cache_state(port) == _cache_state(ref)
    assert len(port) == 2 and port.validated_size <= 3
    assert port.stats.validated_evictions >= len(progs["port"]) - 3
    before = (ref.stats.validated_evictions, port.stats.validated_evictions)
    ref.validate(progs["ref"][-1])
    port.validate(progs["port"][-1])
    assert (ref.stats.validated_evictions,
            port.stats.validated_evictions) == before
    assert _cache_state(port) == _cache_state(ref)


@pytest.mark.parametrize("maxsize,validated_maxsize,n", [
    (2, 3, 8),        # the reference's validate-only test
    (2, None, 40),    # the default bound, 4 * maxsize: 40 programs keep 8
])
def test_validate_only_callers_bounded_like_reference(maxsize,
                                                      validated_maxsize, n):
    progs = _programs(n)
    ref = RProgramCache(maxsize=maxsize, validated_maxsize=validated_maxsize)
    port = TProgramCache(maxsize=maxsize, validated_maxsize=validated_maxsize)
    assert port.validated_maxsize == ref.validated_maxsize
    for rp, tp in zip(progs["ref"], progs["port"]):
        assert port.validate(tp) == ref.validate(rp)
        assert _cache_state(port) == _cache_state(ref)
    assert port.validated_size == min(n, port.validated_maxsize)
    assert port.stats.validated_evictions == n - port.validated_size


def test_live_schedules_keep_their_validation():
    """Validate-only traffic never evicts a schedule that still has a live
    entry, in either package: re-validating it stays a table hit."""
    progs = _programs(10)
    caches = {"ref": RProgramCache(maxsize=2, validated_maxsize=2),
              "port": TProgramCache(maxsize=2, validated_maxsize=2)}
    caches["ref"].get(progs["ref"][0], batch=1, dtype=jnp.float32)
    caches["port"].get(progs["port"][0], batch=1, dtype=torch.float32,
                       device="cpu")
    for pkg, cache in caches.items():
        for p in progs[pkg][1:]:
            cache.validate(p)
        live = progs[pkg][0].schedule_key()
        assert live in cache._validated
        before = cache.stats.validated_evictions
        cache.validate(progs[pkg][0])
        assert cache.stats.validated_evictions == before
    assert _cache_state(caches["port"]) == _cache_state(caches["ref"])


class _Recorder:
    """Stands in for a serve function: records its call, returns a result
    each ``main()`` can print."""

    def __init__(self):
        self.calls = []

    def __call__(self, arch, **kw):
        self.calls.append(dict(kw, arch=arch))
        return types.SimpleNamespace(shape=(1, 1), tokens=np.zeros((1, 1)))


def _drive(monkeypatch, module, argv):
    """Run ``module.main()`` on ``argv`` with ``serve``/``serve_cnn``
    replaced by recorders; return the (cnn, lm) recorders."""
    cnn, lm = _Recorder(), _Recorder()
    monkeypatch.setattr(module, "serve_cnn", cnn)
    monkeypatch.setattr(module, "serve", lm)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    module.main()
    return cnn, lm


@pytest.mark.parametrize("arch,kind", [("vgg16", "cnn"), ("resnet18", "cnn"),
                                       ("minitron-8b", "lm")])
def test_serve_cli_batch_defaults_to_4_like_reference(monkeypatch, capsys,
                                                      arch, kind):
    for module in (r_serve, t_serve):
        cnn, lm = _drive(monkeypatch, module, ["--arch", arch])
        rec = cnn if kind == "cnn" else lm
        assert len(rec.calls) == 1 and len((lm if kind == "cnn"
                                            else cnn).calls) == 0
        assert rec.calls[0]["arch"] == arch
        assert rec.calls[0]["batch"] == 4, module.__name__
    capsys.readouterr()


def test_serve_cli_requires_arch_like_reference(monkeypatch, capsys):
    for module in (r_serve, t_serve):
        with pytest.raises(SystemExit) as exc:
            _drive(monkeypatch, module, [])
        assert exc.value.code == 2, module.__name__
        assert "--arch" in capsys.readouterr().err


@pytest.mark.parametrize("argv,mesh", [([], "host"), (["--mesh", "none"],
                                                      "none"),
                                       (["--mesh", "host"], "host")])
def test_serve_cli_mesh_like_reference(monkeypatch, capsys, argv, mesh):
    for module in (r_serve, t_serve):
        cnn, _ = _drive(monkeypatch, module,
                        ["--arch", "vgg16", "--session", *argv])
        assert cnn.calls[0]["mesh"] == mesh, module.__name__
        assert cnn.calls[0]["session"] is True
    capsys.readouterr()


def _stub_graph(weights):
    import threading
    import weakref
    from repro_torch.core import executor
    return executor._Graph(None, None, None,
                           tuple(weakref.ref(t) for t in weights), [], {},
                           threading.Lock())


def test_graph_table_keeps_every_live_weight_set():
    """F3: five weight sets of one entry called in rotation on one stream
    for three rounds miss only in the first round (one capture per weight
    set, where a fixed bound of four graphs missed every call); a weight
    set that dies takes its graph with it, and the others keep theirs."""
    import gc
    from repro_torch.core import executor
    table = executor._GraphTable(executor.STREAMS_PER_WEIGHTS)
    weights = [torch.zeros(2) for _ in range(5)]
    stream, misses = 7, []
    for rnd in range(3):
        for i, w in enumerate(weights):
            key = (stream, (w.data_ptr(),))
            if table.get(key) is None:
                misses.append((rnd, i))
                table.put(key, _stub_graph([w]))
    assert misses == [(0, i) for i in range(5)]
    assert len(table) == 5
    dead_key = (stream, (weights[2].data_ptr(),))
    del weights[2]
    gc.collect()
    assert table.get(dead_key) is None and len(table) == 4
    for w in weights:
        assert table.get((stream, (w.data_ptr(),))) is not None
    # one weight set over more streams than the bound keeps its most recent
    w = weights[0]
    for s in range(8, 8 + executor.STREAMS_PER_WEIGHTS):
        table.put((s, (w.data_ptr(),)), _stub_graph([w]))
    assert table.get((stream, (w.data_ptr(),))) is None
    assert len(table) == 3 + executor.STREAMS_PER_WEIGHTS


# ---------------------------------------------------------------------------
# F4: bfloat16 checkpoint leaves
# ---------------------------------------------------------------------------

def _bf16_values():
    """float32 values, bf16 leaves of each package rounded from them (both
    round to nearest even), and an fp32 and an int32 leaf beside them."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((3, 5)) * 7).astype(np.float32)
    n = rng.standard_normal(4).astype(np.float32)
    f = rng.standard_normal(6).astype(np.float32)
    r_tree = {"w": jnp.asarray(w, jnp.bfloat16),
              "layers": [{"n": jnp.asarray(n, jnp.bfloat16)}],
              "f": jnp.asarray(f), "step": jnp.int32(3)}
    t_tree = {"w": torch.from_numpy(w).to(torch.bfloat16),
              "layers": [{"n": torch.from_numpy(n).to(torch.bfloat16)}],
              "f": torch.from_numpy(f),
              "step": torch.tensor(3, dtype=torch.int32)}
    return r_tree, t_tree


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_reference_bf16_checkpoint_restores_bit_for_bit(tmp_path):
    r_tree, t_tree = _bf16_values()
    r_ckpt.save(str(tmp_path), 2, r_tree)
    got, step = t_ckpt.restore(str(tmp_path), t_tree, device="cpu")
    assert step == 2
    assert got["w"].dtype == got["layers"][0]["n"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits(got["w"]), np.asarray(r_tree["w"]).view(np.int16))
    np.testing.assert_array_equal(
        _bits(got["layers"][0]["n"]),
        np.asarray(r_tree["layers"][0]["n"]).view(np.int16))
    assert torch.equal(got["f"], t_tree["f"])
    assert torch.equal(got["w"], t_tree["w"])


def test_bf16_archive_members_byte_equal_to_reference(tmp_path):
    r_tree, t_tree = _bf16_values()
    r_ckpt.save(str(tmp_path / "r"), 2, r_tree)
    t_ckpt.save(str(tmp_path / "t"), 2, t_tree)
    arch = {}
    for pkg in ("r", "t"):
        d = tmp_path / pkg / "step_00000002"
        with zipfile.ZipFile(d / "arrays.npz") as zf:
            arch[pkg] = {name: zf.read(name) for name in zf.namelist()}
        arch[pkg + "_manifest"] = json.loads(
            (d / "manifest.json").read_text())
    assert arch["t"] == arch["r"]
    assert arch["t_manifest"] == arch["r_manifest"]
    assert arch["t_manifest"]["keys"]["w"] == {"shape": [3, 5],
                                               "dtype": "bfloat16"}


def test_bf16_training_state_round_trips_on_the_cpu(tmp_path):
    """Two train steps of reduced minitron-8b in bf16, then the state saved
    blocking and async and restored: every leaf ``torch.equal``."""
    cfg = dataclasses.replace(get_config("minitron-8b").reduced(),
                              dtype="bfloat16")
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = adamw.init(params)
    step = steps.make_train_step(cfg, adamw.AdamWConfig())
    for i in range(2):
        params, state, m = step(params, state, batch_for_step(
            DataConfig(cfg.vocab_size, 16, 2), i))
        assert torch.isfinite(m["loss"])
    tree = (params, state)
    t_ckpt.save(str(tmp_path / "a"), 2, tree)
    t_ckpt.save(str(tmp_path / "b"), 2, tree, blocking=False).join(60)
    for d in ("a", "b"):
        got, _ = t_ckpt.restore(str(tmp_path / d), tree, device="cpu")
        for x, y in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(tree)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert got[0]["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# F5: no kernel runs under autograd
# ---------------------------------------------------------------------------

def _f(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _wrapper_cases():
    """(name, wrapper call, plain version call, the float operands)."""
    p, w, b = _f(10, 12), _f(12, 6, seed=1), _f(6, seed=2)
    a3, b3, bias3 = _f(2, 5, 4), _f(2, 4, 3, seed=1), _f(2, 3, seed=2)
    tiles, x = _f(3, 4, 4, 2), _f(1, 5, 5, 2, seed=1)
    marr, mbias = _f(16, 4, 3), _f(3, seed=1)
    rng = np.random.default_rng(3)
    qa = torch.from_numpy(rng.integers(-127, 128, (8, 16)).astype(np.int8))
    qb = torch.from_numpy(rng.integers(-127, 128, (16, 4)).astype(np.int8))
    qbias = torch.from_numpy(rng.integers(-99, 99, 4).astype(np.int32))
    mult = torch.full((4,), 0.01)
    q, k, v = _f(4, 9, 8), _f(2, 9, 8, seed=1), _f(2, 9, 8, seed=2)
    xm, g = _f(2, 8, 8, 4, seed=3), _f(3, 3, 4, 8, seed=4)
    pads = ((1, 1), (1, 1))
    return [
        ("conv_gemm_f32", lambda: conv_gemm_f32(p, w, b),
         lambda: conv_gemm_ref(p, w, b), (p, w, b)),
        ("conv_implicit_f32", lambda: conv_implicit_f32(xm, g, pads=pads),
         lambda: conv_implicit_ref(xm, g, pads=pads), (xm, g)),
        ("bmm_f32", lambda: bmm_f32(a3, b3, bias3),
         lambda: bmm_ref(a3, b3, bias3), (a3, b3, bias3)),
        ("wino_input_transform_f32",
         lambda: wino.wino_input_transform_f32(tiles, 2),
         lambda: wino.wino_input_transform_ref(tiles, 2), (tiles,)),
        ("wino_input_transform_nhwc_f32",
         lambda: wino.wino_input_transform_nhwc_f32(x, 2),
         lambda: wino.wino_input_transform_nhwc_ref(x, 2), (x,)),
        ("wino_output_transform_f32",
         lambda: wino.wino_output_transform_f32(marr, mbias, 2),
         lambda: wino.wino_output_transform_ref(marr, mbias, 2), (marr,
                                                                  mbias)),
        ("wino_output_transform_nhwc_f32",
         lambda: wino.wino_output_transform_nhwc_f32(marr, mbias, 2,
                                                     (1, 4, 4)),
         lambda: wino.wino_output_transform_nhwc_ref(marr, mbias, 2,
                                                     (1, 4, 4)),
         (marr, mbias)),
        ("qmm_i8", lambda: qmm_i8(qa, qb, qbias, mult),
         lambda: qmm_ref(qa, qb, qbias, mult), (mult,)),
        ("flash_attention_kernel", lambda: flash_attention_kernel(q, k, v),
         lambda: flash_attention_ref(q, k, v), (q, k, v)),
        ("flash_attention", lambda: flash_attention(
            q[None], k[None], v[None])[0],
         lambda: flash_attention_ref(q, k, v), (q, k, v)),
    ]


@pytest.mark.parametrize("case", _wrapper_cases(), ids=lambda c: c[0])
def test_kernel_wrappers_refuse_autograd(case):
    name, call, plain, operands = case
    expect = plain()
    for t in operands:
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            assert torch.equal(call(), expect)
        t.requires_grad_(False)
    assert torch.equal(call(), expect)    # grad on, no operand needs it


def test_lm_hopper_attention_refuses_autograd():
    """At 2048 tokens the ``hopper`` attention runs K6 (its plain version
    here): under autograd it raises, where the ``torch`` backend's scan
    trains; under ``torch.no_grad()`` the two agree."""
    cfg = get_config("minitron-8b").reduced()
    p = layers.init_attention(torch.Generator().manual_seed(0), cfg,
                              torch.float32, "cpu")
    x = _f(1, layers.LONG_SEQ, cfg.d_model).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        layers.attention(p, x, cfg, backend="hopper")
    out, _ = layers.attention(p, x, cfg, backend="torch")
    assert out.grad_fn is not None
    with torch.no_grad():
        hop, _ = layers.attention(p, x, cfg, backend="hopper")
    np.testing.assert_allclose(hop.numpy(), out.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# F6: a 1x1 strided conv with one output column on hopper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,hw,c,stride", [(2, 2, 4, 2), (2, 2, 32, 2),
                                           (3, 3, 8, 3), (2, 4, 16, 4)])
def test_im2col_of_a_strided_1x1_conv_with_one_column_is_contiguous(
        n, hw, c, stride):
    """r = s = 1, stride > 1, wo = 1: the patch rows are one strided view
    of the input (rows ``stride`` pixels apart), which ``reshape`` returns
    without a copy; K1 takes contiguous operands only."""
    x = torch.randn(n, hw, hw, c)
    patches, (ho, wo) = im2col(x, 1, 1, stride, ((0, 0), (0, 0)))
    assert wo == 1 and patches.is_contiguous()
    assert torch.equal(patches, x[:, ::stride, ::stride, :].reshape(-1, c))
    w = torch.randn(c, 5)
    y = conv_gemm_f32(patches, w, None, False, "is")
    assert torch.equal(y, conv_gemm_ref(patches, w, None, False, "is"))


def test_hopper_serves_resnet18_16_8_like_the_reference_xla():
    """``resnet18_specs(16, 8)``: ``s4b1_proj`` is a 1x1 stride-2 conv from
    2x2 to 1x1. Batch 2 on ``hopper`` (the kernels' plain versions here)
    within 1e-4 of the reference's ``xla`` logits."""
    r_specs = r_resnet.resnet18_specs(16, 8)
    t_specs = t_resnet.resnet18_specs(16, 8)
    proj = next(s for s in t_specs if s.name == "s4b1_proj")
    assert (proj.r, proj.stride, proj.h, proj.w) == (1, 2, 2, 2)
    r_params = r_api.random_params(r_specs, seed=0)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    want = np.asarray(r_api.Accelerator.build(
        r_specs, batch=2, params=r_params, backend="xla")(jnp.asarray(x)))
    params = t_api.params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in r_params], "cpu")
    for opt_level in (0, 1):
        acc = t_api.Accelerator.build(t_specs, batch=2, params=params,
                                      backend="hopper", opt_level=opt_level,
                                      device="cpu")
        y = acc(x).numpy()
        assert y.shape == want.shape and np.isfinite(y).all()
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
