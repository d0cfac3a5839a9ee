"""The per-layer metrics read from the program's spans: a run of the
harness at the test size on the CPU gives each a value; a program that
records none of their spans gives none, and raises nothing."""

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
