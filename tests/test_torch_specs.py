"""``repro_torch.launch.specs`` against the reference's ``launch/specs.py``,
both abstract (fake tensors against ``jax.ShapeDtypeStruct``), at full
width: ``input_specs`` for every LM arch and every shape of ``SHAPES``
(keys, shapes and dtypes, the caches and each family's extras included),
``abstract_params`` and ``abstract_cache`` leaf by leaf. Nothing is
allocated on either side."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs.base import get_config as r_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as R_SHAPES  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES  # noqa: E402
from repro_torch.launch import specs  # noqa: E402

LM_ARCHS = [a for a in list_archs() if a != "vgg16"]


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _ref_leaves(tree) -> dict:
    return {_key(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    leaves = pytree.tree_flatten_with_path(tree)[0]
    for _, leaf in leaves:
        assert isinstance(leaf, FakeTensor)
    return {_key(p): (tuple(l.shape), str(l.dtype).removeprefix("torch."))
            for p, l in leaves}


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    got = specs.input_specs(get_config(arch), SHAPES[shape])
    want = r_specs.input_specs(r_get_config(arch), R_SHAPES[shape])
    assert list(got) == list(want)
    assert _port_leaves(got) == _ref_leaves(want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_params_and_cache_equal_the_reference(arch):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    got = _port_leaves(specs.abstract_params(cfg))
    assert got == _ref_leaves(r_specs.abstract_params(r_cfg))
    n = sum(torch.Size(s).numel() for s, _ in got.values())
    assert n >= 0.9 * cfg.param_count()
    assert (_port_leaves(specs.abstract_cache(cfg, 3, 80))
            == _ref_leaves(r_specs.abstract_cache(r_cfg, 3, 80)))


def test_one_mode_holds_every_spec_of_a_cell():
    """Given one mode, the params and inputs it makes share it (two fake
    modes do not mix), and a step can be traced on them together."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train import steps
    cfg = get_config("minitron-8b").reduced()
    mode = FakeTensorMode()
    params = specs.abstract_params(cfg, mode)
    ins = specs.input_specs(cfg, SHAPES["decode_32k"], mode)
    assert all(t.fake_mode is mode for t in pytree.tree_leaves(
        (params, ins)))
    _, decode = steps.make_serve_steps(cfg)
    with mode:
        logits, cache = decode(params, ins["token"], ins["cache"], 7)
    assert tuple(logits.shape) == (128, cfg.vocab_size)
    assert cache is ins["cache"]
