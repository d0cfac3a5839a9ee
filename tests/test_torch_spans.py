"""The port's spans and counters (mpassit_tpu_torch/spans.py).

One make_case namelist, run by the port on the CPU: in memory with a cold
weight cache, again with it warm, once under MPASSIT_PROFILE, and streamed.
Each span of the recorder's table is recorded under its name with its
parent; a stage's children sum to no more than the stage; the counters
count the cache's loads and builds and the bytes fetched; each span agrees
with its event in the profiled run's Chrome trace within 1 ms once placed
on the trace's clock; the streamed writer's blocks come from its own
thread."""

import gc
import json
import os
import sys
import threading
import time

import pytest
import torch

from mpassit_tpu_torch import spans
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.ops import packed_kernel as pk
from mpassit_tpu_torch.run import pipeline as tpipe
from mpassit_tpu_torch.tools import trace_summary as ts

from test_pipeline import make_case
from test_torch_pipeline import _port

#: the top-level stages, in the order a run opens them
STAGES = ("define_target_grid", "define_input_grid", "route_fields",
          "read_input_data", "reorder_cells", "weight_generation",
          "interp_data", "write_to_file")

#: span -> the names its parent may have (None: a top-level span)
PARENTS = {
    "route_fields": {None},
    "reorder_cells": {None},
    "weights.build": {"weight_generation"},
    "weights.pack": {"weight_generation", "interp_data"},
    "apply.operands": {"weight_generation", "interp_data", "restagger"},
    "apply.upload": {"interp_data", "restagger"},
    "apply.fetch": {"interp_data", "restagger"},
    "restagger": {"interp_data"},
    "write.store": {"write_to_file", "write.block"},
    "write.block": {None},
    "write.finish": {"write_to_file"},
}

#: spans only a streamed run opens
STREAMED = ("write.block", "write.finish")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(d, **over):
    _, cfg, _, _ = make_case(d, cfg_overrides=over or None)
    return _port(cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Cold and warm in-memory runs on one weight cache, with the columns
    each fetch brought to the host (the spy beside ``_fetch_strips``) and
    the kernel's plain calls; a streamed run."""
    d = tmp_path_factory.mktemp("spans")
    cache = str(d / "cache")
    fetched, out = [], {}
    fetch = tm._fetch_strips

    def spy(o, C, ny, nx, lo0, *a, **kw):
        fetched.append(4 * ny * nx * (min(lo0 + o.shape[2], C) - lo0))
        return fetch(o, C, ny, nx, lo0, *a, **kw)

    tm._fetch_strips = spy
    try:
        for tag in ("cold", "warm"):
            fetched.clear()
            pk.PLAIN_CALLS = 0
            art = tpipe.run_pipeline(
                _cfg(d, weights_cache_dir=cache,
                     output_file=str(d / f"{tag}.nc")), device="cpu")
            out[tag] = (art, sum(fetched), pk.PLAIN_CALLS)
    finally:
        tm._fetch_strips = fetch
    cfg = _cfg(d, output_file=str(d / "streamed.nc"))
    cfg.stream_output = True
    out["streamed"] = tpipe.run_pipeline(cfg, device="cpu")
    return out


def _parent_name(t, s):
    return None if s.parent is None else t.spans[s.parent].name


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_every_span_has_its_parent(runs, name):
    t = (runs["streamed"] if name in STREAMED else runs["cold"][0]).timings
    got = [s for s in t.spans if s.name == name]
    assert got, name
    assert {_parent_name(t, s) for s in got} <= PARENTS[name]
    assert all(s.t0 <= s.t1 for s in got)
    if name == "weights.pack":
        # each method's pack at weight_generation, the union at interp_data
        assert {_parent_name(t, s) for s in got} == PARENTS[name]


def test_stages_are_the_sums_of_their_spans(runs):
    t = runs["cold"][0].timings
    top = [s.name for s in t.spans if s.parent is None]
    assert list(dict.fromkeys(top)) == list(STAGES)
    assert top.count("route_fields") == 2        # before and after the read
    for name, sec in t.stages.items():
        assert sec == pytest.approx(sum(s.t1 - s.t0 for s in t.spans
                                        if s.name == name))


@pytest.mark.parametrize("tag", ["cold", "streamed"])
def test_children_sum_to_no_more_than_their_stage(runs, tag):
    art = runs[tag][0] if tag == "cold" else runs[tag]
    t = art.timings
    kids = {}
    for s in t.spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    assert kids
    for i, ch in kids.items():
        p = t.spans[i]
        assert sum(s.t1 - s.t0 for s in ch) <= p.t1 - p.t0, p.name
        assert all(p.t0 <= s.t0 and s.t1 <= p.t1 for s in ch), p.name
    for name in STAGES:
        inside = sum(s.t1 - s.t0 for s in t.spans if s.parent is not None
                     and t.spans[s.parent].name == name)
        assert inside <= t.stages.get(name, 0.0), name


def test_cache_counters_cold_then_warm(runs):
    cold, warm = runs["cold"][0], runs["warm"][0]
    n_methods = len(cold.regridders)
    assert cold.timings.counts["weights.cache_misses"] == n_methods
    assert "weights.cache_hits" not in cold.timings.counts
    assert warm.timings.counts["weights.cache_hits"] == n_methods
    assert "weights.cache_misses" not in warm.timings.counts
    n_packs = cold.timings.counts["pack.cache_misses"]
    # every method's own pack and the union of the cell methods
    assert n_packs == n_methods + 1
    assert warm.timings.counts["pack.cache_hits"] == n_packs
    assert "pack.cache_hits" not in cold.timings.counts
    builds = [s for s in cold.timings.spans if s.name == "weights.build"]
    assert len(builds) == n_methods
    assert not any(s.name == "weights.build" for s in warm.timings.spans)


@pytest.mark.parametrize("tag", ["cold", "warm"])
def test_fetch_upload_and_group_counters(runs, tag):
    art, fetched, plain_calls = runs[tag]
    c = art.timings.counts
    assert c["apply.fetch_bytes"] == fetched > 0
    assert c["apply.upload_bytes"] > 0
    # one launch of the route's kernel (here its plain version) a group
    assert c["apply.groups"] == plain_calls > 0
    fetches = [s for s in art.timings.spans if s.name == "apply.fetch"]
    assert len(fetches) == c["apply.groups"]


def test_no_recorder_records_nothing():
    assert spans.active() is None
    with spans.span("apply.fetch") as s:
        spans.count("apply.fetch_bytes", 4)
    assert s._rec is None
    t = spans.Timings()
    with spans.recording(t):
        assert spans.active() is t
        with spans.span("a"), spans.span("b"):
            spans.count("n", 2)
    assert spans.active() is None
    assert [(s.name, s.parent) for s in t.spans] == [("a", None), ("b", 0)]
    assert t.counts == {"n": 2}


def test_threads_record_into_one_recorder():
    """More threads than cores, each entering the recorder and opening
    nested spans and counts under a short switch interval: no span or
    count is lost, each parent is its own thread's enclosing span."""
    t, n_threads, n = spans.Timings(), 3 * (os.cpu_count() or 2), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with spans.recording(t):
            for _ in range(n):
                with spans.span("outer"), spans.span("inner"):
                    spans.count("n", 1)

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert t.counts == {"n": n_threads * n}
    assert len(t.spans) == 2 * n_threads * n
    for s in t.spans:
        if s.name == "outer":
            assert s.parent is None
        else:
            p = t.spans[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert p.t0 <= s.t0 <= s.t1 <= p.t1
    assert t.stages["outer"] == pytest.approx(
        sum(s.t1 - s.t0 for s in t.spans if s.name == "outer"))


def test_streamed_blocks_come_from_the_writer_thread(runs):
    t = runs["streamed"].timings
    main = threading.get_native_id()
    blocks = [s for s in t.spans if s.name == "write.block"]
    assert blocks and all(s.thread != main and s.parent is None
                          for s in blocks)
    assert len({s.thread for s in blocks}) == 1
    stores = [s for s in t.spans if s.name == "write.store"]
    assert {s.thread for s in stores} == {main, blocks[0].thread}
    # the finish waited for the thread: every block ended before it did
    fin = [s for s in t.spans if s.name == "write.finish"]
    assert len(fin) == 1 and max(s.t1 for s in blocks) <= fin[0].t1


def test_spans_match_the_trace_within_1_ms(tmp_path, monkeypatch):
    """Every span of a profiled run against its ``user_annotation`` event
    (same name and thread, in order), placed on the trace's clock through
    the recorder's anchor and the trace's ``baseTimeNanoseconds``.

    A span reads its clock just outside its ``record_function`` (t0
    before the event starts, t1 after it ends), so the event lies inside
    the span: that holds for every span within 1 ms. Each end agrees with
    the event's within 1 ms plus the time the thread spent off the CPU
    between the span's clock read and the ``record_function`` call beside
    it: spans.py's clock and ``record_function`` are watched here, each
    call paired with the thread's CPU time, since a thread descheduled
    there (up to 8 ms under the whole suite's load) widens the span by that
    time, whatever the clock. The collector is off during the run, so its
    pauses fall in no span."""
    reads = []                  # (what, perf_counter, thread CPU seconds)
    real_rf = torch.profiler.record_function

    class clock:
        time_ns = staticmethod(time.time_ns)

        @staticmethod
        def perf_counter():
            t = time.perf_counter()
            reads.append(("clock", t, time.thread_time()))
            return t

    class watched(real_rf):
        def __enter__(self):
            r = super().__enter__()
            reads.append(("entered", time.perf_counter(), time.thread_time()))
            return r

        def __exit__(self, *a):
            reads.append(("exiting", time.perf_counter(), time.thread_time()))
            return super().__exit__(*a)

    monkeypatch.setenv("MPASSIT_PROFILE", str(tmp_path / "p"))
    cfg = _cfg(tmp_path)
    monkeypatch.setattr(spans, "time", clock)
    monkeypatch.setattr(torch.profiler, "record_function", watched)
    gc.collect()
    gc.disable()
    try:
        art = tpipe.run_pipeline(cfg, device="cpu")
    finally:
        gc.enable()
    (path,) = (tmp_path / "p").iterdir()
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == ts.STAGE_CAT:
            events.setdefault((e["name"], int(e["tid"])), []).append(e)
    t = art.timings
    at = {r[1]: k for k, r in enumerate(reads) if r[0] == "clock"}

    def off_cpu_us(a, b):
        (_, pa, ca), (_, pb, cb) = reads[a], reads[b]
        return max(0.0, (pb - pa) - (cb - ca)) * 1e6

    mine = {}
    for s in t.spans:
        mine.setdefault((s.name, s.thread), []).append(s)
    assert set(mine) <= set(events)
    for key, ss in mine.items():
        evs = sorted(events[key], key=lambda e: float(e["ts"]))
        assert len(evs) == len(ss), key
        for s, e in zip(ss, evs):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            d0, d1 = t.trace_us(s.t0, base) - a, t.trace_us(s.t1, base) - b
            assert d0 <= 1000.0 and d1 >= -1000.0, (key, d0, d1)
            k, m = at[s.t0], at[s.t1]
            assert reads[k + 1][0] == "entered" and reads[m - 1][0] == (
                "exiting")
            assert -d0 <= 1000.0 + off_cpu_us(k, k + 1), (key, d0)
            assert d1 <= 1000.0 + off_cpu_us(m - 1, m), (key, d1)
