"""The counted work of the layer table against the hand-worked figures,
and the table against the published network."""
import json

import pytest

from bench_tiny import ROOT, table
from bench.yardstick import work


def _layers(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())["layers"]


def test_vgg16_counted_work():
    layers = _layers("vgg16-fp32")
    assert work.flops_per_image(layers) / 1e9 == pytest.approx(30.9405, abs=1e-4)
    assert work.bound_s(layers, 8) * 1e3 == pytest.approx(0.748, abs=5e-4)
    compute, memory = work.bound_terms_s(layers, 8)
    assert compute * 1e3 == pytest.approx(0.500, abs=5e-4)
    assert memory * 1e3 == pytest.approx(0.455, abs=5e-4)


@pytest.mark.parametrize("name,counts", [
    ("vgg16-fp32", {"conv": 13, "pool": 5, "fc": 3})])
def test_tables_hold_the_published_layers(name, counts):
    layers = _layers(name)
    got = {}
    for layer in layers:
        got[layer["kind"]] = got.get(layer["kind"], 0) + 1
    assert got == counts
    assert layers[-1]["d_out"] == 1000


def test_the_table_is_the_programs_network():
    from repro_torch.models import vgg
    specs = vgg.network_specs(224, 1, n_classes=1000)
    assert _layers("vgg16-fp32") == table(specs)


def test_bound_is_the_larger_term_per_layer():
    conv = dict(kind="conv", name="c", h=8, w=8, c=4, k=4, r=3, s=3,
                stride=2, padding="SAME", relu=True)
    assert work.out_hw(conv) == (4, 4)
    assert work.layer_flops(conv, 2) == 2 * 2 * 4 * 4 * 9 * 16
    assert work.layer_bytes(conv, 2) == 4 * (2 * (256 + 64) + 144 + 4)
    pool = dict(kind="pool", name="p", h=8, w=8, c=4, window=2, stride=2)
    assert work.layer_flops(pool, 3) == 0
    assert work.bound_s([conv, pool], 2) == pytest.approx(
        max(work.layer_flops(conv, 2) / 494.7e12,
            work.layer_bytes(conv, 2) / 3.35e12)
        + work.layer_bytes(pool, 2) / 3.35e12)
