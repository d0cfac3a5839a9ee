"""BENCHMARK.json against the benchmark's contract, and the harness finding
each configuration, traffic mix and metric by name from its files."""

import json
import os
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", [])) <= cells
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in BENCH[k]}) == len(BENCH[k])
        assert all(UNIT.match(m["unit"]) and m["better"] in
                   ("lower", "higher") for m in BENCH[k])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"]
    mix = spec.traffic(w["traffic"])
    assert mix["weights_cache"] in ("checkout", "none")
    assert w["chips"] == 1 and len(w["why"]) <= 200
    entry = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert os.path.exists(os.path.join(spec.ROOT, entry["file"]))
    assert entry["file"].startswith("portbench/")
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(m):
    read = spec.reader(m["name"])
    ctx = {"hours": [], "trace": None, "window_s": 1.0, "setup_s": 2.0,
           "peak_host_bytes": None, "peak_device_bytes": 0,
           "stage_mean": lambda names: None,
           "count_mean": lambda names: None}
    v = read(ctx)
    # without hours or a trace a reader finds nothing, except set-up's
    # and the device peak's, which every run has
    assert v is None or m["name"] in ("setup_s", "peak_device_gb")


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(BENCH, w["name"],
                                                  "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(BENCH, w["name"], "per_layer")


def test_configs_used_and_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
