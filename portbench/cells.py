"""Finding a cell's parts by name.

A workload of ``BENCHMARK.json`` names a configuration and a traffic mix;
each sits in a file of its own (``portbench/configs/<config>.json``,
``portbench/traffic/<traffic>.json``), the comparison's limits in
``portbench/limits/<workload>.json``, each per-layer metric's reader in
``portbench/metrics/<metric>.py`` and each model family's plain reference
in ``portbench/reference/<family>.py``.  Nothing here knows a cell: a cell
added as files and entries is found the same way.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, workload: str, end_to_end: list[dict]) -> bool:
    """Whether a metric is reported in ``workload``: listed there, or
    listing no cells and moving (or being) a metric the cell reports."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        return any(m["name"] == metric["moves"] for m in end_to_end)
    return True


def load(workload: str, bench: dict | None = None,
         limits: dict | None = None) -> Cell:
    """The workload's parts; ``limits`` stands in for its limits file."""
    bench = _json(ROOT / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = _json(HERE / "configs" / f"{w['config']}.json")
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    if limits is None:
        limits = _json(HERE / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, [])]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, e2e)]
    if traffic["chips"] != w["chips"]:
        raise SystemExit(f"{workload}: BENCHMARK.json asks for {w['chips']} "
                         f"chips, its traffic mix for {traffic['chips']}")
    return Cell(workload, w["chips"], conf, traffic, limits, e2e, per_layer)


def reference(family: str) -> ModuleType:
    return load_module(HERE / "reference" / f"{family}.py",
                       f"portbench_reference_{family}")


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))
