"""A cell by its name: its entry in BENCHMARK.json, its workload file
(workloads/<cell>.json: the check's sampling and limits), its traffic file
(traffic/<traffic>.json) and its configuration file (configs/<config>.json),
and the metrics BENCHMARK.json gives it."""
from __future__ import annotations

import dataclasses
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    workload: dict
    traffic: dict
    config: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, manifest: str | None = None) -> Cell:
    bench = _load(manifest or os.path.join(ROOT, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    workload = _load(HERE, "workloads", f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json: {key} {workload[key]!r} is not "
                             f"BENCHMARK.json's {entry[key]!r}")
    return Cell(name=name, entry=entry, workload=workload,
                traffic=_load(HERE, "traffic", f"{entry['traffic']}.json"),
                config=_load(HERE, "configs", f"{entry['config']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
