"""Every cell, configuration and metric of BENCHMARK.json loads and is a
file of its own that the harness finds by name."""

import json
import re

import pytest

from portbench import cell as cells
from portbench.cell import PKG, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_entries_have_just_the_contract_keys():
    for conf in BENCH["configs"]:
        assert set(conf) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    c = cells.load(w["name"])
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert c.chips == 1
    assert c.config["name"] == w["config"]
    assert set(c.limits) == {"median_lane_excess", "lane_shortfall"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("portbench/")
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"] == []
    assert 1 <= len(conf["source"]) <= 200
    assert 1 <= len(conf["why"]) <= 200 and "\n" not in conf["why"]
    assert (ROOT / data["dataset"]).is_file()
    assert len(data["dataset_sha256"]) == 64


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert (PKG / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
    assert callable(cells.reader(m["name"]))
    cellnames = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cellnames)) <= cellnames
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_configuration_used_and_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
