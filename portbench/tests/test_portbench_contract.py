"""BENCHMARK.json against the benchmark's contract, and the harness finding
its parts by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import cells

BENCH = json.load(open(cells.ROOT / "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_sources(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    moved = e2e[metric["moves"]]
    for w in metric["workloads"]:
        assert w in moved.get("workloads", [w])


@pytest.mark.parametrize("workload", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_metric_and_a_layer(workload):
    cell = cells.load(workload["name"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert workload["chips"] in (1, 4)
    assert len(workload["why"]) <= 200


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_reader_declares_the_unit_of_its_entry(metric):
    assert cells.metric_reader(metric["name"]).UNIT == metric["unit"]


def test_config_files_hold_their_cuts():
    for c in BENCH["configs"]:
        conf = json.load(open(cells.ROOT / c["file"]))
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
        assert c["file"].startswith("portbench/")


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later change adds a traffic mix, a limits file and an entry: the
    harness's code is left as it is."""
    copy = tmp_path / "portbench"
    shutil.copytree(cells.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    tr = json.load(open(copy / "traffic" / "mll.w4.b2s2048.json"))
    tr.update(name="mll.w4.b1s4096", batch={"sequences": 1,
                                            "seq_len": 4096})
    json.dump(tr, open(copy / "traffic" / "mll.w4.b1s4096.json", "w"))
    shutil.copy(copy / "limits" / "qwen3-1.7b.w4.train.json",
                copy / "limits" / "qwen3-1.7b.w4.long.json")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "qwen3-1.7b.w4.long",
                               "config": "qwen3-1.7b",
                               "traffic": "mll.w4.b1s4096", "chips": 1,
                               "why": "long sequences"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen3-1.7b.w4.train" in m.get("workloads", []):
            m["workloads"].append("qwen3-1.7b.w4.long")
    mod = cells.load_module(copy / "cells.py", "portbench_cells_copy")
    cell = mod.load("qwen3-1.7b.w4.long", bench)
    assert cell.traffic["batch"] == {"sequences": 1, "seq_len": 4096}
    assert cell.config["name"] == "qwen3-1.7b"
    assert {m["name"] for m in cell.per_layer} >= {"grads.worker_ms",
                                                   "step.mfu"}
