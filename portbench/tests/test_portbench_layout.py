"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric is a file of its own, found by name; names, units
and entries keep to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    bench, entry, config, params, limits = harness.cell_files(cell)
    assert config["reduced"] == [] and config["source"]
    assert os.path.exists(os.path.join(harness.PB, "traffic",
                                       params["kind"] + ".py"))
    assert limits, "a cell's file states the limits of its comparison"
    e2e = harness.cell_metrics(bench, cell, False)
    layer = harness.cell_metrics(bench, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in {x["name"] for x in e2e}
        assert os.path.exists(os.path.join(harness.PB, "metrics",
                                           m["name"] + ".py"))
    for m in e2e:
        assert os.path.exists(os.path.join(harness.PB, "metrics",
                                           m["name"] + ".py"))


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.load(open(os.path.join(ROOT, c["file"])))["source"] \
            == c["source"]


def test_one_more_cell_needs_only_its_file_and_an_entry(tmp_path):
    shutil.copytree(harness.PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "cifar10.serve.bulk",
                               "config": "cifar10", "traffic": "serve.bulk",
                               "chips": 1, "why": "a later cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mnist40.serve.bulk" in m.get("workloads", []):
            m["workloads"].append("cifar10.serve.bulk")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "workloads" / "cifar10.serve.bulk.json") \
        .write_text(json.dumps({"limits": {"out_gap": 5e-6}}))
    _, entry, config, params, limits = harness.cell_files(
        "cifar10.serve.bulk", root=str(tmp_path))
    assert config["model"]["image_shape"] == [3, 32, 32]
    assert params["kind"] == "serve_closed_loop" and limits
    names = {m["name"] for m in harness.cell_metrics(
        bench, "cifar10.serve.bulk", True)}
    assert names == {m["name"] for m in BENCH["per_layer"]
                     if "mnist40.serve.bulk" in m.get("workloads", [])}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
