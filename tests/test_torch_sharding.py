"""The port's input shapes and partition rules against the reference:
``configs.shapes`` row for row; ``param_specs`` and ``zero1_specs`` leaf
for leaf for every LM arch at full size and reduced, on meshes of shape
(1, 1), (16, 16) and (2, 16, 16) (the spec functions read only a mesh's
``axis_names`` and ``devices.shape``, so the reference runs on a stand-in
with those two); ``shard`` is the identity; a ``NamedSharding`` resolves
to the mesh's first device, splits a dense leaf over the ``model``
positions and holds the other families whole, and places checkpoint
restores."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as RP  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs import shapes as r_shapes  # noqa: E402
from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.configs.base import list_archs as r_list_archs  # noqa: E402
from repro.parallel import sharding as r_sharding  # noqa: E402
from repro.train import steps as r_steps  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import elastic_restore  # noqa: E402
from repro_torch.compat import make_mesh  # noqa: E402
from repro_torch.configs import get_config, list_archs, shapes  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402
from repro_torch.train import steps  # noqa: E402

LM_ARCHS = [a for a in r_list_archs() if r_get_config(a).family != "cnn"]
MESHES = {(1, 1): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


class _StandIn:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@functools.lru_cache(maxsize=None)
def _abstract_params(arch: str, reduced: bool):
    cfg = r_get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    return jax.eval_shape(
        lambda: r_steps.init_params(jax.random.PRNGKey(0), cfg))


def _meta_tree(abstract):
    """The same tree with ``meta`` tensors of the reference's shapes."""
    return jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta"), abstract)


def test_shapes_equal_reference():
    assert shapes.SHAPE_NAMES == r_shapes.SHAPE_NAMES
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == \
        {k: vars(v) for k, v in r_shapes.SHAPES.items()}
    archs = r_list_archs()
    assert list_archs() == archs
    assert shapes.cells([get_config(a) for a in archs]) == \
        r_shapes.cells([r_get_config(a) for a in archs])
    assert len(shapes.cells([get_config(a) for a in LM_ARCHS])) == 40


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=str)
def test_rules_spec_equal_reference(mesh_shape):
    names = MESHES[mesh_shape]
    rules = sharding.make_rules(_StandIn(mesh_shape, names))
    r_rules = r_sharding.make_rules(_StandIn(mesh_shape, names))
    assert rules.dp_axes == r_rules.dp_axes
    logical = [None, sharding.BATCH, sharding.SEQ, sharding.EMBED,
               sharding.HEADS, sharding.KV_HEADS, sharding.MLP,
               sharding.VOCAB, sharding.EXPERT, sharding.STACK,
               sharding.SSM_HEADS, sharding.CONV]
    assert rules.spec(*logical) == tuple(r_rules.spec(*logical))
    with pytest.raises(ValueError, match="unknown logical axis"):
        rules.spec("rows")


@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=str)
@pytest.mark.parametrize("reduced", [False, True],
                         ids=["full", "reduced"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_zero1_specs_equal_reference(arch, reduced, mesh_shape):
    names = MESHES[mesh_shape]
    abstract = _abstract_params(arch, reduced)
    meta = _meta_tree(abstract)
    rules = sharding.make_rules(_StandIn(mesh_shape, names))
    r_rules = r_sharding.make_rules(_StandIn(mesh_shape, names))
    for fn, r_fn in ((sharding.param_specs, r_sharding.param_specs),
                     (sharding.zero1_specs, r_sharding.zero1_specs)):
        got = {_key(p): s for p, s in pytree.tree_flatten_with_path(
            fn(meta, rules), is_leaf=lambda x: isinstance(x, P))[0]}
        want = {_key(p): tuple(s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    r_fn(abstract, r_rules),
                    is_leaf=lambda x: isinstance(x, RP))[0]}
        assert got.keys() == want.keys()
        for k in want:
            assert isinstance(got[k], P), k
            assert got[k] == want[k], (fn.__name__, k, got[k], want[k])


def test_shard_is_the_identity():
    x = torch.ones(4, 6)
    assert sharding.current_rules() is None
    assert sharding.shard(x, sharding.BATCH, None) is x
    rules = sharding.make_rules(make_mesh((1, 1), ("data", "model"),
                                          device_type="cpu"))
    with sharding.use_rules(rules):
        assert sharding.current_rules() is rules
        assert sharding.shard(x, sharding.BATCH, sharding.MLP) is x
        assert sharding.shard(x[:, :5], None, sharding.MLP).shape == (4, 5)
        with pytest.raises(ValueError, match="unknown logical axis"):
            sharding.shard(x, "rows")
    assert sharding.current_rules() is None


def test_named_sharding_resolves_to_the_one_device():
    """A placement's ``device`` is its mesh's first position's: the one
    device of a one-device mesh, and over several distinct devices the
    one where a whole tensor lives and a split one's collectives sum. A
    dense leaf over two distinct devices is split onto them; ``steps.place``
    holds a family not yet split (the SSM's) whole on the first device
    (ROADMAP 11i)."""
    one = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    rules = sharding.make_rules(one)
    assert rules.sharding(None, sharding.MLP).device == torch.device("cpu")
    assert not rules.sharding(None, sharding.MLP).splits
    repeated = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert sharding.make_rules(repeated).sharding(sharding.BATCH).device \
        == torch.device("cpu")
    two = make_mesh((1, 2), ("data", "model"), devices=["cpu", "meta"])
    rules = sharding.make_rules(two)
    s = rules.sharding(None, sharding.MLP)
    assert s.device == torch.device("cpu") and s.splits
    assert s.devices == s.row_devices(0) == [torch.device("cpu"),
                                             torch.device("meta")]
    placed = sharding.place_tensor(torch.ones(3, 4), s)
    assert [(t.device.type, tuple(t.shape)) for t in placed.shards] == [
        ("cpu", (3, 2)), ("meta", (3, 2))]
    cfg = get_config("minitron-8b").reduced()
    dense = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sharding.is_split(sharding.place(
        dense, sharding.param_shardings(dense, rules)))
    assert sharding.is_split(steps.place(cfg, dense, rules))
    ssm_cfg = get_config("mamba2-130m").reduced()
    ssm = steps.init_params(ssm_cfg, torch.Generator().manual_seed(0), "cpu")
    held = steps.place(ssm_cfg, ssm, rules)
    assert sharding.is_split(held)
    layer = held["layers"]
    for name in ("in_proj", "A_log"):
        assert [(t.device.type, t.dtype, tuple(t.shape))
                for t in layer[name].parts] == [
            (d, ssm["layers"][name].dtype,
             (*ssm["layers"][name].shape[:-1],
              ssm["layers"][name].shape[-1] // 2)) for d in ("cpu", "meta")]
    assert [t.device.type for t in layer["norm2"].parts] == ["cpu"]
    assert torch.equal(layer["in_proj"].parts[0],
                       ssm["layers"]["in_proj"][..., :148])
    assert P(("data",), None) == ("data", None)
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_restore_onto_param_shardings(tmp_path):
    """``restore(shardings=)`` and ``elastic_restore`` take the placements
    ``param_shardings`` returns (the reference's docstring names it)."""
    cfg = get_config("minitron-8b").reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ckpt.save(str(tmp_path), 4, params)
    rules = sharding.make_rules(make_mesh((1, 1), ("data", "model"),
                                          device_type="cpu"))
    places = sharding.param_shardings(params, rules)
    assert isinstance(places["embed"], sharding.NamedSharding)
    assert places["embed"].spec == (None, "model")
    got, step = ckpt.restore(str(tmp_path), params, shardings=places)
    assert step == 4 and torch.equal(got["lm_head"], params["lm_head"])
    got, _ = elastic_restore(str(tmp_path), params, rules,
                             sharding.param_shardings)
    for (path, a), b in zip(
            pytree.tree_flatten_with_path(got)[0],
            pytree.tree_leaves(params)):
        assert torch.equal(a, b), _key(path)
