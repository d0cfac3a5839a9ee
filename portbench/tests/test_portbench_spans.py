"""The per-layer metrics read from the program's spans: a run of the
harness at the test size on the CPU gives each a value; a program that
records none of their spans gives none, and raises nothing. The program's
counters reach a reader as ``count_mean``."""

import pytest

from portbench import spec
from portbench.tests.helpers import tiny_run

NEW = ("entry_s", "pack_s", "upload_s", "fetch_s", "write_transform_s")


@pytest.mark.parametrize("traffic", ["hourly_cached", "hourly_cold"])
def test_span_metrics_have_values(tmp_path, traffic):
    r, _ = tiny_run(tmp_path, spec.traffic(traffic))
    r.workload = "conus3km.warm"
    got = r.metrics(spec.benchmark(), "per_layer")
    for name in NEW:
        assert got[name]["value"] is not None and got[name]["unit"] == "s"
        assert got[name]["value"] > 0, name
    assert got["write_transform_s"]["value"] < got["write_s"]["value"]
    assert got["upload_s"]["value"] + got["fetch_s"]["value"] < (
        got["interp_s"]["value"])


def test_span_metrics_silent_without_spans(tmp_path):
    """The stages a program without the spans records (the six of the
    reference's sequence): no value, no error; a streamed run's stores
    are on the writer's thread, so no transform share either."""
    r, _ = tiny_run(tmp_path, spec.traffic("hourly_cached"))
    hours = r.hours
    old = ("define_target_grid", "define_input_grid", "read_input_data",
           "weight_generation", "interp_data", "write_to_file")
    r.hours = [dict(h, stages={k: h["stages"][k] for k in old})
               for h in hours]
    for name in NEW:
        assert spec.reader(name)(r.context()) is None, name
    r.hours = [dict(h, stages=dict(h["stages"], **{"write.block": 1.0}))
               for h in hours]
    assert spec.reader("write_transform_s")(r.context()) is None


def test_bench_lists_the_span_metrics():
    bench = spec.benchmark()
    by = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = by[name]
        assert m["source"] == "program_span" and m["moves"] == "hour_s"
        assert m["workloads"] == ["conus3km.warm", "ncep218.cold"]


def test_counters_reach_a_reader(tmp_path, monkeypatch):
    """Each hour keeps the program's counters beside its spans; a reader
    that asks ``count_mean`` for them gets their mean over the hours, and
    for a counter no hour records, None, so the metric is left out."""
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "f64_mb.py").write_text(
        "def read(ctx):\n"
        "    v = ctx['count_mean'](('write.f64_bytes',))\n"
        "    return None if v is None else v / 1e6\n")
    (metrics / "nothing.py").write_text(
        "def read(ctx):\n    return ctx['count_mean'](('no.such',))\n")
    monkeypatch.setattr(spec, "METRICS", str(metrics))
    r, _ = tiny_run(tmp_path, spec.traffic("hourly_cold"), seconds=0.2)
    hours = r.hours
    assert len(hours) >= 2
    for h in hours:
        assert {"apply.fetch_bytes", "apply.upload_bytes", "apply.groups",
                "weights.cache_misses", "write.f64_bytes"} <= set(h["counts"])
    bench = {"end_to_end": [
        {"name": n, "unit": "MB", "better": "lower", "bound": 0.25,
         "source": "host_clock"} for n in ("f64_mb", "nothing")],
        "per_layer": []}
    got = r.metrics(bench, "end_to_end")
    want = sum(h["counts"]["write.f64_bytes"] for h in hours) / len(hours)
    assert got == {"f64_mb": {"value": want / 1e6, "unit": "MB"}}
    assert r.context()["count_mean"](("apply.groups", "no.such")) == sum(
        h["counts"]["apply.groups"] for h in hours) / len(hours)
