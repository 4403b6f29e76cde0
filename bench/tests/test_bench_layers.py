"""Layer kinds found by name: the VGG16 table reads as it did when the
kinds were written in the walkers, the table's wiring reaches the port's
specs, a key or a name the port cannot take is refused, and a new kind is
its two files."""
import json
import shutil
import subprocess
import sys

import pytest

from bench import harness
from bench.reference import net
from bench.yardstick import inputs, work
from bench_tiny import ROOT, table, tiny_dw_chain, tiny_resnet18

VGG16 = json.loads((ROOT / "bench" / "configs" / "vgg16-fp32.json")
                   .read_text())["layers"]


def test_vgg16_specs_are_the_programs_network():
    from repro_torch.models import vgg
    assert harness.to_specs(VGG16) == vgg.network_specs(224, 1,
                                                        n_classes=1000)


def test_vgg16_weight_shapes():
    convs = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
             (256, 256), (256, 256), (256, 512)] + [(512, 512)] * 5
    want = [((3, 3, c, k), 9 * c) for c, k in convs] + [
        ((25088, 4096), 25088), ((4096, 4096), 4096), ((4096, 1000), 4096)]
    assert inputs.weight_shapes(VGG16) == want


@pytest.mark.parametrize("batch,bound,terms", [
    (1, 0.0002263286105641592,
     (6.254402393369719e-05, 0.00020141042626865672)),
    (8, 0.0007483646776861599,
     (0.0005003521914695775, 0.00045486214686567164)),
    (128, 0.009758642437008408,
     (0.00800563506351324, 0.004799748785671642))])
def test_vgg16_counted_work_is_unchanged(batch, bound, terms):
    """The figures the walkers gave before kinds had files of their own,
    to the last bit."""
    assert work.flops_per_image(VGG16) == 30940528640
    assert work.bound_s(VGG16, batch) == bound
    assert work.bound_terms_s(VGG16, batch) == terms


def _explicit_pads():
    from repro_torch.core.hybrid_conv import ConvSpec, DepthwiseSpec
    return [ConvSpec("c", 8, 8, 3, 4, r=7, s=7, stride=2,
                     padding=((3, 3), (3, 3))),
            DepthwiseSpec("d", 4, 4, 4, stride=2, padding=((0, 1), (1, 0)))]


@pytest.mark.parametrize("specs", [tiny_resnet18, tiny_dw_chain,
                                   _explicit_pads])
def test_a_table_gives_back_its_spec_chain(specs):
    chain = specs()
    layers = json.loads(json.dumps(table(chain)))
    assert harness.to_specs(layers) == chain


def test_wiring_in_the_table():
    layers = {d["name"]: d for d in table(tiny_resnet18())}
    assert "from" not in layers["s1b1_conv1"]
    assert layers["s1b1_add"]["skip"] == "stem_pool"
    assert layers["s2b1_proj"]["from"] == "s1b2_add"
    assert layers["s2b1_conv1"]["from"] == "s1b2_add"
    assert layers["s2b1_add"]["skip"] == "s2b1_proj"


def test_counted_work_of_the_other_kinds():
    add = dict(kind="add", name="a", h=4, w=4, c=8, relu=True)
    assert work.out_hw(add) == (4, 4)
    assert work.layer_flops(add, 2) == 0
    assert work.layer_bytes(add, 2) == 4 * 2 * 3 * 4 * 4 * 8
    dw = dict(kind="depthwise", name="d", h=8, w=8, c=4, r=3, s=3,
              stride=2, padding="SAME", relu=True)
    assert work.out_hw(dw) == (4, 4)
    assert work.layer_flops(dw, 3) == 2 * 4 * 9 * 16 * 3
    assert work.layer_bytes(dw, 3) == 4 * (3 * 4 * (64 + 16) + 36 + 4)
    pool = dict(kind="pool", name="p", h=112, w=112, c=64, window=3,
                stride=2, pad=1)
    assert work.out_hw(pool) == (56, 56)
    conv = dict(kind="conv", name="c", h=224, w=224, c=3, k=64, r=7, s=7,
                stride=2, padding=[[3, 3], [3, 3]], relu=True)
    assert work.out_hw(conv) == (112, 112)
    assert work.out_hw(dict(conv, padding="VALID")) == (109, 109)
    assert work.out_hw(dict(conv, padding="SAME")) == (112, 112)


def _pool(**kw):
    return dict(kind="pool", name="p", h=8, w=8, c=4, window=2, stride=2,
                **kw)


def _conv(name, **kw):
    return dict(kind="conv", name=name, h=4, w=4, c=4, k=4, r=3, s=3,
                stride=1, padding="SAME", relu=True, **kw)


@pytest.mark.parametrize("layers,words", [
    ([_pool(pad=1)], ["'p'", "PoolSpec", "'pad'"]),
    ([_conv("c0"), _pool(**{"from": "input"})], ["'p'", "'from'"]),
    ([_conv("c0", dilation=2)], ["'c0'", "'dilation'"]),
    ([_conv("c0", inp_from=-1)], ["'c0'", "'inp_from'"]),
    ([_conv("c0", **{"from": "c1"}), _conv("c1")],
     ["'c0'", "'from'", "'c1'"]),
    ([_conv("c0"), dict(kind="add", name="a", h=4, w=4, c=4, skip="nowhere")],
     ["'a'", "'skip'", "'nowhere'"]),
    ([_conv("c0"), _conv("c0")], ["'c0'", "taken"]),
    ([dict(kind="avgpool", name="g")], ["'avgpool'"]),
])
def test_to_specs_refuses_what_the_port_cannot_take(layers, words):
    with pytest.raises(ValueError) as e:
        harness.to_specs(layers)
    assert all(w in str(e.value) for w in words), e.value


@pytest.mark.parametrize("key", ["from", "skip"])
def test_the_reference_refuses_a_name_of_no_earlier_layer(key):
    import torch
    later = [_conv("c0"), dict(kind="add", name="a", h=4, w=4, c=4,
                               skip="c0"), _conv("c1")]
    later[1][key] = "c1"
    with pytest.raises(ValueError, match="'a'.*'c1'"):
        net.forward(later, [(torch.zeros(3, 3, 4, 4), torch.zeros(4))] * 2,
                    torch.zeros(1, 4, 4, 4))


KIND_LAYERS = '''"""``gap``: a global average pool, for the test."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GapSpec:
    name: str
    h: int
    w: int
    c: int


def spec():
    return GapSpec


def out_hw(layer):
    return 1, 1


def flops(layer, batch):
    return batch * layer["h"] * layer["w"] * layer["c"]


def bytes(layer, batch):
    return 4 * batch * (layer["h"] * layer["w"] + 1) * layer["c"]
'''

KIND_REFERENCE = '''"""``gap``: a global average pool, for the test."""


def weight_shape(layer):
    return None


def forward(layer, x, params, skip, cast):
    return x.mean(dim=(1, 2), keepdim=True)
'''

WALK = '''
import json, sys
sys.path[:0] = sys.argv[1:3]
import torch
from bench import harness
from bench.reference import net
from bench.yardstick import inputs, work
layers = json.loads(sys.argv[3])
w = inputs.make_weights(layers, 3, "cpu")
x = torch.randn(2, 4, 4, 3, generator=torch.Generator().manual_seed(0))
want = x.reshape(2, 16, 3).mean(1) @ w[0][0] + w[0][1]
torch.testing.assert_close(net.forward(layers, w, x), want)
specs = harness.to_specs(layers)
print(json.dumps([type(s).__name__ for s in specs]),
      [s for s, _ in inputs.weight_shapes(layers)], work.out_hw(layers[0]),
      work.flops_per_image(layers), work.layer_bytes(layers[0], 2))
'''


def test_a_new_kind_is_its_two_files(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "bench" / "layers" / "gap.py").write_text(KIND_LAYERS)
    (tmp_path / "bench" / "reference" / "gap.py").write_text(KIND_REFERENCE)
    layers = [dict(kind="gap", name="g", h=4, w=4, c=3),
              dict(kind="fc", name="f", d_in=3, d_out=5, relu=False)]
    out = subprocess.run(
        [sys.executable, "-c", WALK, str(tmp_path), str(ROOT / "src"),
         json.dumps(layers)], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [
        '["GapSpec",', '"FCSpec"]', "[(3,", "5)]", "(1,", "1)",
        str(48 + 30), str(4 * 2 * 17 * 3)]
