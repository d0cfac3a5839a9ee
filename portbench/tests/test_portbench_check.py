"""The comparison that decides ``correct``, driven through whole runs of the
harness at the test size on the CPU: sound runs pass it; the program's
own lower-precision path (the control), an output rounded to bfloat16 and
each fault planted in the timed path fail it."""

import copy
import json

import numpy as np
import pytest
import torch

from portbench import check, run, spec
from portbench.reference.expected import Expect
from portbench.tests.helpers import TINY, latlon_config, passes, tiny_run


def _mix(**kw):
    m = copy.deepcopy(spec.traffic("hourly_cached"))
    for k, v in kw.items():
        m[k] = dict(m.get(k, {}), **v) if isinstance(v, dict) else v
    return m


@pytest.mark.parametrize("traffic", ["hourly_cached", "hourly_cold"])
def test_sound_runs_pass(tmp_path, traffic):
    r, numbers = tiny_run(tmp_path, spec.traffic(traffic))
    assert numbers["schema_faults"] == 0, numbers["faults"]
    assert numbers["rel_err"] < check.LIMITS["rel_err"] / 2, numbers["worst"]
    assert len(r.rcs) >= 1 and not any(r.rcs)


def test_streamed_vertex_run_passes(tmp_path):
    """The streaming writer's slab writes reach the sink whole, and the
    vertex-located ``vorticity`` (the reference's vertex fan) agrees."""
    _, numbers = tiny_run(tmp_path, _mix(
        namelist={"stream_output": True},
        varlist_extra={"histlist_3d": [["vorticity", "VORT"]]}))
    assert passes(numbers), (numbers["worst"], numbers["faults"])
    assert numbers["schema_faults"] == 0


def test_regional_latlon_run_passes(tmp_path):
    """The program's CLI on a regional lat-lon target, through the sink:
    every variable at every sampled point agrees with the reference."""
    r, numbers = tiny_run(tmp_path, cfg=latlon_config("regional"))
    assert passes(numbers), (numbers["worst"], numbers["faults"])
    assert "SINALPHA" not in r.recorder.hours[0]["vars"]


def test_global_latlon_run_differs_only_at_the_seam_and_poles(tmp_path):
    """The program's CLI on MPASSIT's global lat-lon target at 4 degrees,
    through the sink. It agrees with the reference everywhere but at U's
    first and last columns (the seam) and V's first and last rows (the
    poles), where it leaves U and V at 0, unmapped as on a regional grid,
    and the reference maps them across the seam and to the pole's mean: a
    fault of the program, pinned here as it stands."""
    r, numbers = tiny_run(tmp_path, cfg=latlon_config("global"))
    g = r.ref.grid
    assert g.periodic and numbers["schema_faults"] == 0
    assert not passes(numbers)
    assert {v for _, v in numbers["worst"][:2]} == {"U", "V"}
    expect = r.ref.expected(r.points)
    (ju, iu), (jv, iv) = r.points["U"], r.points["V"]
    edge = {"U": (iu == 0) | (iu == g.nx), "V": (jv == 0) | (jv == g.ny)}
    assert edge["U"].sum() > 100 and edge["V"].sum() > 100
    for name, at in edge.items():
        ex = expect[name]
        assert np.abs(ex.values[:, at]).min() > 0.05 * ex.scale, name
        for hour in r.recorder.hours:
            assert np.all(hour["vars"][name]["values"][:, at] == 0), name
        expect[name] = Expect(name, ex.values[:, ~at], scale=ex.scale)
        for hour in r.recorder.hours:
            var = hour["vars"][name]
            var["values"] = var["values"][:, ~at]
    again = check.compare(expect, r.recorder.hours, r.rcs)
    assert passes(again), again["worst"]
    assert again["rel_err"] < check.LIMITS["rel_err"] / 2


def test_control_fails(tmp_path):
    """The control: the program's one-hot route with split_bf16, its own
    lower-precision path."""
    _, numbers = tiny_run(tmp_path, _mix(
        namelist={"apply_precision": "split_bf16"},
        env={"MPASSIT_ELL_KERNEL": "0"}))
    assert numbers["schema_faults"] == 0
    assert numbers["rel_err"] > 3 * check.LIMITS["rel_err"], numbers["worst"]


def test_bf16_rounded_output_fails(tmp_path):
    r, numbers = tiny_run(tmp_path)
    assert passes(numbers)
    for hour in r.recorder.hours:
        for var in hour["vars"].values():
            v = var["values"]
            if v.dtype == np.float32:
                var["values"] = torch.from_numpy(v.copy()).to(
                    torch.bfloat16).float().numpy()
    again = check.compare(r.ref.expected(r.points), r.recorder.hours, r.rcs)
    assert not passes(again)


def _patch_apply(monkeypatch, fault):
    """Break the packed apply under the timed path: ``fault(out)`` changes
    the (ny, nx, C) output it returns."""
    from mpassit_tpu_torch.ops import matmul_apply

    orig = matmul_apply.PackedSlabRegridder.apply_np

    def broken(self, src, *a, **kw):
        out = orig(self, src, *a, **kw)
        if out is not None:
            fault(out)
        return out
    monkeypatch.setattr(matmul_apply.PackedSlabRegridder, "apply_np",
                        broken)


def _state_unchanged(out):
    out[...] = 0.0          # the output buffer returned as allocated


def _half_left_out(out):
    out[..., out.shape[-1] // 2:] = 0.0


def _one_answer_altered(out):
    out[..., 3] *= np.float32(1 + 1e-4)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _one_answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_faults_fail(tmp_path, monkeypatch, fault):
    """A step that leaves its output as it found it, half of the columns
    left out, one column altered where it is produced. (The exchange
    between chips has no counterpart: every cell runs on one chip.)"""
    _patch_apply(monkeypatch, fault)
    _, numbers = tiny_run(tmp_path)
    assert not passes(numbers), numbers["worst"]


def test_failed_hour_fails(tmp_path, monkeypatch):
    """An hour whose run exits with an error is counted and fails."""
    from mpassit_tpu_torch.run import pipeline

    r = run.Run("tiny", spec.load_json(TINY), spec.traffic("hourly_cached"),
                5, 0.1, False, torch.device("cpu"), str(tmp_path / "cache"))
    try:
        r.setup()
        monkeypatch.setattr(pipeline, "main", lambda argv: 231)
        r.window(0.0)
        numbers = r.judge()
    finally:
        r.close()
    assert numbers["schema_faults"] >= 1 and not passes(numbers)


def test_failed_last_hour_fails(tmp_path, monkeypatch):
    """Hours that succeed, then one that exits with an error before its
    writer opens a file: the failed hour is counted, though the sink
    recorded only the others."""
    from mpassit_tpu_torch.run import pipeline

    r = run.Run("tiny", spec.load_json(TINY), spec.traffic("hourly_cached"),
                7, 1e9, False, torch.device("cpu"), str(tmp_path / "cache"))
    try:
        r.setup()
        main, calls = pipeline.main, []

        def third_fails(argv):
            calls.append(argv)
            if len(calls) < 3:
                return main(argv)
            r.seconds = 0.0
            return 231
        monkeypatch.setattr(pipeline, "main", third_fails)
        r.window(0.0)
        numbers = r.judge()
    finally:
        r.close()
    assert r.rcs == [0, 0, 231] and len(r.recorder.hours) == 2
    assert numbers["schema_faults"] >= 1 and not passes(numbers)
    assert any("exited with 231" in f for f in numbers["faults"])


def test_result_line_keys(tmp_path):
    """The last line has the contract's keys, ``compared`` last; with a
    trace, ``breakdown`` and the device's busy and window seconds."""
    bench = spec.benchmark()
    for trace in (False, True):
        r, numbers = tiny_run(tmp_path / str(trace), trace=trace)
        r.workload = "conus3km.warm"
        kind = "per_layer" if trace else "end_to_end"
        line = run.result_line(r, numbers, r.metrics(bench, kind))
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line) == keys + (["breakdown"] if trace else []) \
            + ["compared"]
        assert set(line["device"]) == {"platform", "kind", "count",
                                       "memory_peak_bytes"} | (
            {"busy_s", "window_s"} if trace else set())
        assert line["correct"] is True
        json.loads(json.dumps(line))
        names = {m["name"] for m in spec.metrics_of(bench, "conus3km.warm",
                                                    kind)}
        assert set(line["metrics"]) <= names
        if not trace:
            assert {"hour_s", "setup_s", "peak_host_gb"} <= set(
                line["metrics"])
        else:
            assert {"ingest_s", "weights_s", "interp_s", "write_s"} <= set(
                line["metrics"])


@pytest.mark.cuda
def test_on_the_card(tmp_path, card):
    """At the test size on the card: the program's kernels pass, the
    control fails."""
    _, numbers = tiny_run(tmp_path / "a", device="cuda")
    assert passes(numbers), numbers["worst"]
    _, numbers = tiny_run(tmp_path / "b", _mix(
        namelist={"apply_precision": "split_bf16"},
        env={"MPASSIT_ELL_KERNEL": "0"}), device="cuda")
    assert numbers["rel_err"] > 3 * check.LIMITS["rel_err"]
