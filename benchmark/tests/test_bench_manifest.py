"""BENCHMARK.json and the files it names: names, units and sizes within the
benchmark's contract, and every configuration, traffic mix, workload and
metric found by its name."""
import importlib
import json
import os
import re

import pytest

import cells
import check
import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert {m["name"].split(".")[0] for m in bench["end_to_end"]} == {
        "chain_evals_per_s", "eval_ms_p90", "peak_mem_gb", "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names(bench, part):
    names = [e["name"] for e in bench[part]]
    assert len(names) == len(set(names))
    for e in bench[part]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_every_cell_resolves(bench):
    metric_names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        cell = cells.load(w["name"])
        importlib.import_module(f"systems.{cell.config['system']}")
        importlib.import_module(f"reference.{cell.config['system']}").PROBLEM
        importlib.import_module(f"reference.operators.{cell.traffic['deg']}").Operator
        assert cell.workload["limits"], f"{w['name']}: no limit set"
        assert set(cell.workload["limits"]) <= set(check.NUMBERS)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        assert {m["name"] for m in cell.per_layer} <= metric_names
        reported = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in reported for m in cell.per_layer), w["name"]


def test_configs_in_paths(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/") and c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for ref in cfg["reference"]:
            assert os.path.exists(os.path.join(ROOT, "benchmark", ref))


def test_metric_readers(bench):
    for m in bench["per_layer"]:
        mod = run.reader("metrics", m["name"])
        assert callable(mod.read) and isinstance(mod.KERNELS, tuple)
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"]:
        assert callable(run.reader("endtoend", m["name"]).read)
