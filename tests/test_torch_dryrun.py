"""``repro_torch.launch.dryrun`` against the reference's, on the CPU.

The reference's dry-run pins 512 placeholder host devices when imported,
so its side runs in one subprocess (as ``tests/test_multidevice.py``
does): ``trip_count`` and the SKIP verdicts of every LM arch, and JAX's
``NamedSharding.shard_shape`` of every parameter leaf over both production
meshes under the reference's rules. The port's shard shapes
(``NamedSharding.shard_shape`` over the placeholder ``meta`` meshes) must
equal them. Reduced ``run_cell``s write ``OK`` records (and a SKIP) to
``tmp_path``, touching no card; ``lower_cell``'s argument bytes are the
shard shapes' sum."""
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES, applicability  # noqa: E402,E501
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    NamedSharding,
    P,
    make_rules,
    param_shardings,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in list_archs() if a != "vgg16"]


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@functools.lru_cache(maxsize=None)
def _reference() -> dict:
    """arch -> {"trip", "skip": {shape: reason or None}, "single"/"multi":
    {leaf key: shard shape}} from the reference, 512 host devices."""
    code = textwrap.dedent(f"""
        import json
        import jax
        from repro.launch import dryrun
        from repro.configs.base import get_config
        from repro.configs.shapes import SHAPES, applicability
        from repro.launch.mesh import make_production_mesh
        from repro.launch.specs import abstract_params
        from repro.parallel.sharding import make_rules, param_shardings
        assert len(jax.devices()) == 512
        meshes = {{"single": make_production_mesh(multi_pod=False),
                  "multi": make_production_mesh(multi_pod=True)}}
        def key(path):
            return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                            for p in path)
        out = {{}}
        for arch in {LM_ARCHS!r}:
            cfg = get_config(arch)
            rec = out[arch] = {{"trip": dryrun.trip_count(cfg), "skip": {{
                s: (None if applicability(cfg, SHAPES[s])[0]
                    else applicability(cfg, SHAPES[s])[1])
                for s in SHAPES}}}}
            params = abstract_params(cfg)
            for name, mesh in meshes.items():
                shard = param_shardings(params, make_rules(mesh))
                rec[name] = {{
                    key(p): list(s.shard_shape(l.shape)) for (p, l), s in
                    zip(jax.tree_util.tree_flatten_with_path(params)[0],
                        jax.tree.leaves(shard))}}
        print("JSON" + json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(x for x in r.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_trip_count_and_skips_equal_the_reference(arch):
    ref = _reference()[arch]
    cfg = get_config(arch)
    assert dryrun.trip_count(cfg) == ref["trip"]
    for s in SHAPE_NAMES:
        ok, why = applicability(cfg, SHAPES[s])
        assert (None if ok else why) == ref["skip"][s], s


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shard_shapes_equal_jax(arch, multi_pod):
    want = _reference()[arch]["multi" if multi_pod else "single"]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="meta")
    assert mesh.size == (512 if multi_pod else 256)
    assert set(mesh.devices.flat) == {torch.device("meta")}
    params = abstract_params(get_config(arch))
    shard = param_shardings(params, make_rules(mesh))
    got = {_key(p): list(s.shard_shape(leaf.shape)) for (p, leaf), s in zip(
        pytree.tree_flatten_with_path(params)[0], pytree.tree_leaves(
            shard, is_leaf=lambda x: isinstance(x, NamedSharding)))}
    assert got == want


def test_shard_shape_divides_by_the_named_axes():
    mesh = make_mesh((2, 4, 8), ("pod", "data", "model"),
                     device_type="meta")
    s = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert s.shard_shape((16, 3, 64)) == (2, 3, 8)
    assert NamedSharding(mesh, P()).shard_shape((5, 7)) == (5, 7)
    with pytest.raises(ValueError, match="does not divide"):
        s.shard_shape((12, 3, 64))
    assert s.devices == [torch.device("meta")]
    assert s.device == torch.device("meta")


def _reduced(arch):
    return get_config(arch).reduced()


@pytest.mark.parametrize("arch,shape", [
    ("minitron-8b", "train_4k"), ("minitron-8b", "decode_32k"),
    ("llama-3.2-vision-11b", "prefill_32k"), ("mamba2-130m", "long_500k"),
    ("whisper-base", "decode_32k")])
def test_reduced_run_cell_writes_an_ok_record(tmp_path, arch, shape):
    cfg = _reduced(arch)
    rec = dryrun.run_cell(arch, shape, False, out_dir=str(tmp_path),
                          verbose=False, cfg=cfg)
    assert rec["status"] == "OK", rec.get("traceback")
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                         .read_text())
    assert on_disk["status"] == "OK"
    assert rec["n_chips"] == 256 and rec["dp_positions"] == 16
    assert rec["bf16_correction"] == 1.0
    roof = rec["roofline"]
    assert roof["step_time_s"] == max(roof["compute_s"], roof["memory_s"],
                                      roof["collective_s"])
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    assert 0 < rec["useful_flops_ratio"] <= 1.5
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    if SHAPES[shape].kind == "train":
        assert rec["collective_counts"]["all-reduce"] == 16 * len(
            pytree.tree_leaves(abstract_params(cfg)))
    else:
        assert rec["collective_counts"] == {}


def test_run_cell_skips_and_argument_bytes_are_the_shard_shapes(tmp_path):
    rec = dryrun.run_cell("minitron-8b", "long_500k", True,
                          out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "SKIP" and "quadratic" in rec["reason"]
    assert (tmp_path / "minitron-8b__long_500k__multi.json").exists()
    cfg = _reduced("minitron-8b")
    st, mem, *_ = dryrun.lower_cell("minitron-8b", "decode_32k", True,
                                    cfg=cfg)
    mesh = make_production_mesh(multi_pod=True, device_type="meta")
    rules = make_rules(mesh)
    params = abstract_params(cfg)
    want = dryrun._shard_bytes(params, param_shardings(params, rules))
    # the cache (batch over the 32 data positions, positions over model)
    # and the token batch, on top of the params
    cache = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads * cfg.head_dim
    want += 4 * cache // (32 * 16) + 4 * 128 // 32 + 4
    assert mem["argument_size_in_bytes"] == want
    assert mem["alias_size_in_bytes"] == 4 * cache // (32 * 16)
    assert st.flops > 0


def test_dryrun_cli_writes_records(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "minitron-8b", "--shape", "long_500k",
        "--mesh", "both", "--out", str(tmp_path)])
    assert dryrun.main() == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "minitron-8b__long_500k__multi.json",
        "minitron-8b__long_500k__single.json"]
