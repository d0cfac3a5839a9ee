"""MPASSIT_PROFILE in the port and the trace reader of
mpassit_tpu_torch/tools/trace_summary.py.

A profiled CPU run writes a Chrome trace (trace_<pid>_<n>.json in the named
directory, made if missing, n the profiled call of the process: two calls
leave two traces) that loads as JSON and holds every ``Timings`` span as a
``record_function`` event, the streamed writer thread's included; its
result arrays and output file are
bit for bit the unprofiled run's, and within tests/test_torch_pipeline.py's
bound of the JAX package's run of the same namelist. trace_summary is held
to hand-made event lists: overlapping device intervals count once, the
idle share, and each gap named after the innermost stage that encloses
it."""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.run import pipeline as tpipe
from mpassit_tpu_torch.tools import trace_summary as ts

from test_pipeline import make_case
from test_torch_pipeline import _arrays, _assert_results_close, _port
from test_torch_streaming import assert_files_identical

@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trace(d):
    """The one trace in ``d``, named for this process."""
    (path,) = d.iterdir()
    assert path.name.startswith(f"trace_{os.getpid()}_"), path.name
    return path


def _spans(path):
    with open(path) as f:
        trace = json.load(f)
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == ts.STAGE_CAT]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's run, the port's unprofiled and profiled runs of
    one make_case namelist, each to its own output file."""
    d = tmp_path_factory.mktemp("profile")
    _, cfg, _, _ = make_case(d)
    ref = jax_run(cfg, jnp.float32)
    cfg.output_file = str(d / "plain.nc")
    plain = tpipe.run_pipeline(_port(cfg), device="cpu")
    prof_dir = d / "prof" / "new"          # made by the run
    os.environ["MPASSIT_PROFILE"] = str(prof_dir)
    try:
        cfg.output_file = str(d / "profiled.nc")
        prof = tpipe.run_pipeline(_port(cfg), device="cpu")
    finally:
        del os.environ["MPASSIT_PROFILE"]
    return d, ref, plain, prof, prof_dir


def test_profiled_run_writes_a_trace_with_every_stage(runs):
    _, _, _, prof, prof_dir = runs
    names = {e["name"] for e in _spans(_trace(prof_dir))}
    assert set(prof.timings.stages) <= names, (prof.timings.stages, names)


def test_two_profiled_calls_leave_two_traces(tmp_path, monkeypatch):
    _, cfg, _, _ = make_case(tmp_path)
    monkeypatch.setenv("MPASSIT_PROFILE", str(tmp_path / "p"))
    for _ in range(2):
        tpipe.run_pipeline(_port(cfg), device="cpu")
    got = [p.name for p in (tmp_path / "p").iterdir()]
    n = {int(m.group(1)) for g in got
         if (m := re.fullmatch(rf"trace_{os.getpid()}_(\d+)\.json", g))}
    assert len(got) == len(n) == 2, got
    for g in got:
        assert {"interp_data", "write_to_file"} <= {
            e["name"] for e in _spans(tmp_path / "p" / g)}


def test_profiled_output_is_bit_for_bit_the_unprofiled(runs):
    d, _, plain, prof, _ = runs
    a, b = _arrays(prof.result), _arrays(plain.result)
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert_files_identical(str(d / "plain.nc"), str(d / "profiled.nc"))


def test_profiled_output_within_the_jax_bound(runs):
    _, ref, _, prof, _ = runs
    _assert_results_close(prof.result, ref.result)


def test_check_ported_passes_profile(tmp_path, monkeypatch):
    """A profiled run of a sharded namelist (n_device_shards = -1, a mesh
    of one) writes its trace, with the sharded apply's stages in it. (The
    name is kept from when an option check stood before a profiled run,
    so that the test's record stays one.)"""
    _, cfg, _, _ = make_case(tmp_path,
                             cfg_overrides={"n_device_shards": -1})
    monkeypatch.setenv("MPASSIT_PROFILE", str(tmp_path / "p"))
    art = tpipe.run_pipeline(_port(cfg), device="cpu")
    assert art.regridders["bilinear"].mesh is not None
    events = ts.load_events(str(_trace(tmp_path / "p")))
    names = {e.get("name") for e in events}
    assert {"interp_data", "weight_generation"} <= names


def test_streamed_profiled_run_spans(tmp_path, monkeypatch):
    """stream_output: the schema's open and the writer's finish are
    write_to_file spans; every span has its event, the writer thread's
    blocks on a thread of their own."""
    _, cfg, _, _ = make_case(tmp_path)
    cfg.stream_output = True
    monkeypatch.setenv("MPASSIT_PROFILE", str(tmp_path / "p"))
    art = tpipe.run_pipeline(_port(cfg), device="cpu")
    path = _trace(tmp_path / "p")
    spans = _spans(path)
    names = [e["name"] for e in spans]
    assert set(art.timings.stages) <= set(names)
    assert names.count("write_to_file") == 2
    assert names.count("write.block") == sum(
        s.name == "write.block" for s in art.timings.spans)
    assert {e["tid"] for e in spans if e["name"] == "write.block"}.isdisjoint(
        {e["tid"] for e in spans if e["name"] == "write_to_file"})
    summ = ts.summarize(ts.load_events(str(path)))
    # no device on the CPU: the run is all idle
    assert summ["device_events"] == 0 and summ["run"]["idle_share"] == 1.0
    assert summ["stages"]["write_to_file"]["window_s"] > 0


def _x(name, cat, ts_us, dur_us, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "pid": 1, "tid": 1, "args": args}


EVENTS = [
    {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "ts": 0,
     "dur": 1000},
    _x("interp_data", "user_annotation", 100, 800),
    _x("write_to_file", "user_annotation", 500, 300),
    _x("aten::copy_", "cpu_op", 120, 10),
    # 200-300 and 250-400 overlap: busy 200-400 once
    _x("kern_a", "kernel", 200, 100, stream=7),
    _x("Memcpy DtoH", "gpu_memcpy", 250, 150, stream=7),
    _x("kern_a", "kernel", 600, 50, stream=7),
    _x("Memset", "gpu_memset", 640, 20, stream=7),
    _x("not_device", "gpu_user_annotation", 0, 1000),
]


def test_summary_merges_overlapping_device_intervals():
    assert ts.merge([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    s = ts.summarize(EVENTS)
    run = s["run"]
    assert s["device_events"] == 4
    # busy: 200-400 and 600-660 -> 260 us of 1000
    assert run["busy_s"] == pytest.approx(260e-6)
    assert run["window_s"] == pytest.approx(1000e-6)
    assert run["idle_share"] == pytest.approx(0.74)
    ops = {o["name"]: o for o in run["top_ops"]}
    assert ops["kern_a"]["launches"] == 2
    assert ops["kern_a"]["total_ms"] == pytest.approx(0.15)
    assert ops["Memcpy DtoH"]["total_ms"] == pytest.approx(0.15)
    assert "not_device" not in ops


def test_summary_stage_windows_and_gap_names():
    s = ts.summarize(EVENTS)
    st = s["stages"]["interp_data"]              # 100-900
    assert st["busy_s"] == pytest.approx(260e-6)
    assert st["idle_share"] == pytest.approx(1 - 260 / 800)
    wr = s["stages"]["write_to_file"]            # 500-800: busy 600-660
    assert wr["busy_s"] == pytest.approx(60e-6)
    assert [o["launches"] for o in wr["top_ops"]] == [1, 1]
    gaps = [(round(g["start_s"] * 1e6), round(g["s"] * 1e6), g["stage"])
            for g in s["run"]["longest_gaps"]]
    # 660-1000 crosses the end of both stages: no stage encloses it;
    # 400-600 starts in interp_data only; 0-200 before any stage
    assert gaps == [(660, 340, None), (0, 200, None),
                    (400, 200, "interp_data")]
    inner = [(round(g["start_s"] * 1e6), round(g["s"] * 1e6), g["stage"])
             for g in wr["longest_gaps"]]
    assert inner == [(660, 140, "write_to_file"),
                     (500, 100, "write_to_file")]


def test_summary_without_profiler_window_uses_event_extent():
    s = ts.summarize(EVENTS[1:])
    assert s["run"]["window_s"] == pytest.approx(1000e-6)   # the annotation
    assert s["run"]["longest_gaps"][0]["stage"] is None
