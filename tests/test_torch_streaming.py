"""stream_output=.true. in the port: every fetched strip goes straight into
the NetCDF file through StreamingWriter's thread.

The contract, as tests/test_streaming.py holds the JAX package to it: the
port's streamed file equals the port's in-memory file (the same variables
in the same order, the same dims and attributes, every array bit for bit),
for Lambert and regional lat-lon, across strip seams, with per-field
conservative applies, and through the column-grouped packed apply. Against
the JAX package's streamed file the bound is tests/test_torch_pipeline.py's
file tolerance (1e-5 of each variable's largest magnitude).

The port's StreamingWriter does not copy the two faults of the JAX
package's: a put that lands after the writer thread died raises there
(rather than only at ``finish``), and ``finish`` closes the file when it
raises."""

import dataclasses
import queue
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.io import wrf_writer as j_writer
from mpassit_tpu.io.nc4 import open_dataset
from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.config import Config as PortConfig
from mpassit_tpu_torch.io import wrf_writer as t_writer
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.run import pipeline as tpipe

from test_pipeline import make_case

LATLON = {"target_grid_type": "lat-lon", "dx": 1.8, "dy": 1.5,
          "truelat1": None, "stand_lon": None}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    return PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)})


def _run_both(tmp, stream_env=None, monkeypatch=None, **case):
    """The port's in-memory run, then its streamed run (under
    ``stream_env``), of the same make_case inputs; returns both configs and
    the streamed run's artifacts."""
    d1, d2 = tmp / "inmem", tmp / "stream"
    d1.mkdir()
    d2.mkdir()
    _, cfg1, _, _ = make_case(d1, **case)
    tpipe.run_pipeline(_port(cfg1), device="cpu")
    _, cfg2, _, _ = make_case(d2, **case)
    cfg2.stream_output = True
    for k, v in (stream_env or {}).items():
        monkeypatch.setenv(k, v)
    art = tpipe.run_pipeline(_port(cfg2), device="cpu")
    # streaming held none of the output categories
    assert art.result.diag2d == [] and art.result.nz3d == []
    assert art.result.u is None and art.result.v is None
    return cfg1, cfg2, art


def assert_files_identical(ref_path, got_path):
    with open_dataset(ref_path) as a, open_dataset(got_path) as b:
        assert a.var_names() == b.var_names()      # same vars, same order
        assert a.dim_names() == b.dim_names()
        assert a.global_attr_names() == b.global_attr_names()
        for k in a.global_attr_names():
            assert np.array_equal(a.get_attr(k), b.get_attr(k)), k
        for name in a.var_names():
            assert a.var_dims(name) == b.var_dims(name), name
            assert a.var_attrs(name) == b.var_attrs(name), name
            x, y = np.asarray(a.read_var(name)), np.asarray(b.read_var(name))
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), name


@pytest.mark.parametrize("target", ["lambert", "latlon-regional"])
def test_streamed_file_equals_in_memory(tmp_path, target):
    """Lambert runs the in-kernel wind rotation and the deferred U10/V10;
    regional lat-lon neither."""
    over = LATLON if target == "latlon-regional" else {}
    cfg1, cfg2, art = _run_both(tmp_path, cfg_overrides=over)
    assert art.timings.stages["write.block"] > 0
    assert "write.finish" in art.timings.stages
    assert_files_identical(cfg1.output_file, cfg2.output_file)


@pytest.mark.parametrize("cb,fetch", [(3, 128), (7, 512)])
def test_streamed_seams_multiple_strips_per_var(tmp_path, monkeypatch, cb,
                                                fetch):
    """A strip width below nz: every 3-D variable (PHB/Z_C stitching and
    the P_HYD top level feeding P_TOP included) spans several strips with
    odd level boundaries. CB and FETCH, where the group rule starts, are
    patched for both runs (FETCH stays a multiple of the kernels'
    128-column block)."""
    monkeypatch.setattr(tm, "CB", cb)
    monkeypatch.setattr(tm, "FETCH", fetch)
    cfg1, cfg2, _ = _run_both(tmp_path, nz=5)
    assert_files_identical(cfg1.output_file, cfg2.output_file)


def test_streamed_per_field_conservative_and_dump(tmp_path, monkeypatch):
    """interp_as_bundle=.false.: each conservative field is its own
    streamed apply. MPASSIT_DUMP_RESULT then holds no output category."""
    over = {"interp_as_bundle": False}
    dump = tmp_path / "dump.npz"
    cfg1, cfg2, _ = _run_both(tmp_path, {"MPASSIT_DUMP_RESULT": str(dump)},
                              monkeypatch, cfg_overrides=over)
    assert_files_identical(cfg1.output_file, cfg2.output_file)
    with np.load(dump) as z:
        assert not [k for k in z.files if "." in k or k in ("u", "v")]


def test_streamed_grouped_equals_in_memory_full_width(tmp_path, monkeypatch):
    """A device budget far below the pack's working set: the streamed run's
    packed apply runs in column groups (nz=64 packs over 512 columns), the
    in-memory run's in one pass; the files are identical."""
    seen, groups = [], []
    width = tm.PackedSlabRegridder._grouped_width
    padded = tm.PackedSlabRegridder._apply

    def width_spy(self, Cp, rotate=()):
        gw = width(self, Cp, rotate)
        if gw:
            seen.append((Cp, gw))
        return gw

    def padded_spy(self, src_dev, ranges, g=0, rotate=()):
        groups.append(g)
        return padded(self, src_dev, ranges, g, rotate)
    monkeypatch.setattr(tm.PackedSlabRegridder, "_grouped_width", width_spy)
    monkeypatch.setattr(tm.PackedSlabRegridder, "_apply", padded_spy)
    monkeypatch.delenv("MPASSIT_DEVICE_BUDGET_GB", raising=False)
    cfg1, cfg2, _ = _run_both(tmp_path, {"MPASSIT_DEVICE_BUDGET_GB": "1e-4"},
                              monkeypatch, nz=64)
    assert len(seen) == 1
    Cp, gw = seen[0]
    assert gw % tm.LANE == 0 and -(-Cp // gw) >= 2
    assert set(range(gw, Cp, gw)) <= set(groups)
    assert_files_identical(cfg1.output_file, cfg2.output_file)


def test_streamed_file_matches_jax_streamed(tmp_path):
    _, cfg, _, _ = make_case(tmp_path)
    cfg.stream_output = True
    jax_run(cfg, jnp.float32)
    jax_out = cfg.output_file
    cfg.output_file = str(tmp_path / "out_torch.nc")
    tpipe.run_pipeline(_port(cfg), device="cpu")
    with open_dataset(jax_out) as fj, open_dataset(cfg.output_file) as ft:
        assert ft.var_names() == fj.var_names()
        assert ft.global_attr_names() == fj.global_attr_names()
        for v in fj.var_names():
            assert ft.var_dims(v) == fj.var_dims(v), v
            assert ft.var_attrs(v).keys() == fj.var_attrs(v).keys(), v
            x, y = ft.read_var(v), fj.read_var(v)
            assert x.shape == y.shape and x.dtype == y.dtype, v
            if x.dtype.kind == "f":
                fin = np.isfinite(y) & (np.abs(y) < 9e36)
                bound = 1e-5 * max(1.0, float(np.abs(y[fin]).max(initial=0)))
                assert np.abs(x[fin] - y[fin]).max(initial=0) <= bound, v
            else:
                np.testing.assert_array_equal(x, y, err_msg=v)


class _DiesOnPut(queue.Queue):
    """A queue whose put lets the writer thread die (as ``_drain`` does on
    a write error: the exception is recorded) just before the item lands,
    after the producer's first health check."""

    def __init__(self, writer):
        super().__init__(maxsize=2)
        self.writer = writer

    def put(self, item, block=True, timeout=None):
        self.writer._exc = OSError("disk full")
        super().put(item, block, timeout)


def _bare_writer(mod):
    w = mod.StreamingWriter.__new__(mod.StreamingWriter)
    w._exc = None
    w._q = _DiesOnPut(w)
    return w


def test_put_landing_after_the_thread_died_raises():
    """The port raises the write error at that put; the JAX package's copy
    returns as if the block were queued, and the error surfaces only when
    ``finish`` re-raises it."""
    blk = np.zeros((2, 2), np.float32)
    with pytest.raises(OSError, match="disk full"):
        _bare_writer(t_writer).put("X", 0, blk)
    j = _bare_writer(j_writer)
    j.put("X", 0, blk)
    assert j._q.qsize() == 1 and j._exc is not None


class _File:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def _failed_writer(mod):
    """A writer whose thread has ended on a write error."""
    w = mod.StreamingWriter.__new__(mod.StreamingWriter)
    w._q = queue.Queue(maxsize=2)
    w._exc = OSError("disk full")
    w._thread = threading.Thread(target=lambda: None)
    w._thread.start()
    w.f = _File()
    return w


def test_finish_closes_the_file_when_it_raises():
    """The port closes the file and drops its handle; the JAX package's
    copy leaves it open."""
    w = _failed_writer(t_writer)
    f = w.f
    with pytest.raises(OSError, match="disk full"):
        w.finish()
    assert f.closed and w.f is None
    j = _failed_writer(j_writer)
    with pytest.raises(OSError, match="disk full"):
        j.finish()
    assert not j.f.closed
