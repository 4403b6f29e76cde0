"""BENCHMARK.json against the files the harness finds by name, and the
contract's rules on names and cells."""
import json
import re

import pytest

from bench import harness
from bench_tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        harness._reader(m["name"], ROOT)


def test_a_split_metric_falls_back_to_its_base_reader():
    metrics = ROOT / "bench" / "metrics"
    assert not (metrics / "pe_roofline.bulk.py").exists()
    assert harness._reader("pe_roofline.bulk", ROOT).__module__ \
        == harness._reader("pe_roofline", ROOT).__module__ \
        .replace("pe_roofline", "pe_roofline_bulk")
    own = harness._reader("mfu.online", ROOT)
    assert own.__doc__ is None and "busy time" in own.__globals__["__doc__"]
    with pytest.raises(FileNotFoundError):
        harness._reader("no_such_metric.bulk", ROOT)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in _cells(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in _cells(m)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], cell)


def test_a_layer_metric_moves_an_end_to_end_one_in_each_of_its_cells():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        assert set(_cells(m)) <= set(_cells(E2E[m["moves"]])), m["name"]
    rooflines = [m for m in BENCH["per_layer"]
                 if m["name"].split(".")[0].endswith("_roofline")]
    for r in rooflines:
        assert r["unit"] == "%"
        assert any("mfu" in m["name"] and m["moves"] == r["moves"]
                   for m in BENCH["per_layer"])
