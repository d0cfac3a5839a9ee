"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells; a cell
names its configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``); each metric is read by
``metrics/<metric>.py``'s ``read(ctx)``. A cell, a mix or a metric is
added by adding its files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONFIGS = os.path.join(HERE, "configs")
METRICS = os.path.join(HERE, "metrics")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(CONFIGS, name + ".json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    that list it, or list no cells and move (or, end to end, are) a metric
    the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(METRICS, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
