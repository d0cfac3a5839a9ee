"""mpassit_tpu_torch/tools/bench_production.py at a tiny size on the CPU.

Both measured children run the CLI on MPASSIT_PLATFORM=cpu, each in its
own process. With ``--writer netcdf4`` the streamed and in-memory files are
equal bit for bit; with ``--writer digest`` the two digest maps are equal
and complete, and equal to the digests of the real files, read back (so
the stand-in digests exactly what the NetCDF4 writer stores). With h5py
blocked from import, ``--writer netcdf4`` writes the same files. One flipped
value makes both comparisons name its variable; ``--rss-only`` starts from
an empty mismatch list (the JAX tool keeps stale names). The inputs equal
the JAX tool's ``build_inputs`` at the same size, read back, and the
streamed file is within tests/test_torch_streaming.py's bound (1e-5 of each
variable's largest magnitude) of the JAX package's run of the same
namelist. Nothing is written to the root PRODUCTION_E2E.json."""

import hashlib
import importlib.util
import json
import os
import shutil
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.config import Config as JaxConfig
from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.io.nc4 import open_dataset
from mpassit_tpu_torch.tools import bench_production as bp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_ARTIFACT = os.path.join(REPO, "PRODUCTION_E2E.json")
#: a few thousand cells, nz 3, a 40x30 CONUS grid (135 km)
SIZE = dict(ncells=3000, nz=3, nx=40, ny=30)
ARGS = ["--ncells", "3000", "--nz", "3", "--nx", "40", "--ny", "30"]


digest_netcdf = bp.digest_file


def _root_state():
    if not os.path.exists(ROOT_ARTIFACT):
        return None
    with open(ROOT_ARTIFACT, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def cpu_platform():
    old = os.environ.get("MPASSIT_PLATFORM")
    os.environ["MPASSIT_PLATFORM"] = "cpu"
    yield
    if old is None:
        del os.environ["MPASSIT_PLATFORM"]
    else:
        os.environ["MPASSIT_PLATFORM"] = old


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("production"))


@pytest.fixture(scope="module")
def root_before():
    return _root_state()


@pytest.fixture(scope="module")
def netcdf4_run(cache, cpu_platform, root_before, tmp_path_factory):
    """The netcdf4 run; its two files moved aside (a later run of the
    tool starts by removing them), as {tag: path}."""
    res, d = bp.run_production(cache, "netcdf4", keep_outputs=True, **SIZE)
    kept = tmp_path_factory.mktemp("files")
    files = {tag: shutil.move(os.path.join(d, f"rss_{tag}.nc"),
                              str(kept / f"{tag}.nc"))
             for tag in ("streamed", "in_memory")}
    return res, d, files


@pytest.fixture(scope="module")
def digest_run(cache, cpu_platform, netcdf4_run):
    res, d = bp.run_production(cache, "digest", **SIZE)
    maps = {}
    for tag in ("streamed", "in_memory"):
        with open(os.path.join(d, f"rss_{tag}.json")) as f:
            maps[tag] = json.load(f)["digests"]
    return res, maps


def test_netcdf4_children_write_equal_files(netcdf4_run):
    res, _, files = netcdf4_run
    assert res["ok"] and not res.get("rss_run_errors"), res
    assert res["streamed_equals_inmemory_file"] is True
    assert res["writer_mismatch"] == []
    assert res["writer"] == "netcdf4" and res["platform"] == "cpu"
    assert res["reduced"][0].startswith("ncells 3000 < 2600000")
    assert res["output_gb"] == os.path.getsize(files["streamed"]) / 1e9
    assert res["n_cols"] == 18 + 3 + 3 + 2 + 1 + 33 + 8 + 3 + 6 + 12
    for tag in ("streamed", "in_memory"):
        pre = res["pre_first_apply"][tag]
        assert pre["import_torch_s"] > 0 and pre["cuda_context_s"] is None
        assert res["peak_host_rss_mb_subprocess"][tag] > 0
        assert res["peak_device_gb_subprocess"][tag] is None
        assert res["subprocess_stages"][tag]["write_to_file"] > 0
    assert "stream_overlap" in res["subprocess_writer"]["streamed"]
    assert "skipped" in res["fetch_probe"]
    assert {"bilinear", "nearest", "conserve", "vertex", "edge1",
            "edge2"} == set(res["warm_weights"])


def test_netcdf4_writer_runs_without_h5py(cache, cpu_platform, netcdf4_run,
                                         tmp_path, monkeypatch):
    """--writer netcdf4 with h5py blocked from import in the tool's process
    and in both children (an ``h5py`` on their path that raises
    ImportError): both files are written, compared through the port's
    reader, and bit for bit the files of the run where h5py is installed."""
    stub = tmp_path / "blocked" / "h5py"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("h5py blocked")\n')
    monkeypatch.setenv("PYTHONPATH", str(stub.parent) + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setitem(sys.modules, "h5py", None)
    res, d = bp.run_production(cache, "netcdf4", keep_outputs=True, **SIZE)
    assert res["ok"] and not res.get("rss_run_errors"), res
    assert res["streamed_equals_inmemory_file"] is True
    assert res["writer_mismatch"] == []
    _, _, files = netcdf4_run
    for tag in ("streamed", "in_memory"):
        assert res["subprocess_stages"][tag]["write_to_file"] > 0
        assert bp.compare_files(os.path.join(d, f"rss_{tag}.nc"),
                                files[tag]) == []


def test_digest_maps_equal_and_complete(digest_run):
    res, maps = digest_run
    assert res["ok"] and res["streamed_equals_inmemory_digest"] is True
    assert res["writer_mismatch"] == [] and res["digest_missing"] == {}
    assert maps["streamed"] == maps["in_memory"]
    assert res["digest_levels"] == sum(len(v)
                                       for v in maps["streamed"].values())
    assert res["output_gb"] > 0
    for tag in ("streamed", "in_memory"):
        st = res["subprocess_stages"][tag]
        assert st["write_to_file"] is None and "digest_s" not in st
        w = res["subprocess_writer"][tag]
        assert w["reason"] == bp.NO_WRITER and w["writer_times"] is None
        assert w["digest_stand_in_s"]["write_to_file"] > 0
        assert 0 < w["digest_stand_in_s"]["digest_s"]
    assert res["subprocess_stages"]["streamed"]["write.block"] is None


def test_digest_stand_in_digests_what_the_file_stores(netcdf4_run,
                                                      digest_run):
    _, _, files = netcdf4_run
    _, maps = digest_run
    for tag in ("streamed", "in_memory"):
        got = digest_netcdf(files[tag])
        assert list(got) == list(maps[tag])
        assert got == maps[tag]


@pytest.mark.parametrize("var,index", [("T2", (0, 5, 7)),
                                       ("T", (0, 1, 4, 9))])
def test_one_flipped_value_is_reported_by_both_modes(netcdf4_run, tmp_path,
                                                     var, index):
    _, _, files = netcdf4_run
    ref = files["streamed"]
    bad = str(tmp_path / "flipped.nc")
    shutil.copy(files["in_memory"], bad)
    with h5py.File(bad, "r+") as f:
        a = f[var][...]
        a[index] = np.nextafter(a[index], np.float32(np.inf))
        f[var][...] = a
    assert bp.compare_files(ref, bad) == [var]
    mismatch, missing = bp.compare_digests(digest_netcdf(ref),
                                           digest_netcdf(bad))
    assert mismatch == [var] and missing == {}


def test_missing_level_is_reported():
    a = {"T": ["x", "y"], "T2": ["z"]}
    b = {"T": ["x", None], "T2": ["z"]}
    assert bp.compare_digests(a, b) == (["T"], {"T": [1]})


def test_rss_only_drops_a_stale_mismatch(cache, cpu_platform, netcdf4_run,
                                         tmp_path):
    out = tmp_path / "artifact.json"
    out.write_text(json.dumps({"writer_mismatch": ["STALE"],
                               "streamed_equals_inmemory_file": False}))
    rc = bp.main(["--rss-only", "--writer", "digest", "--cache-dir", cache,
                  "--out", str(out)] + ARGS)
    got = json.loads(out.read_text())
    assert rc == 0 and got["ok"]
    assert got["writer_mismatch"] == []
    assert got["streamed_equals_inmemory_digest"] is True


def test_inputs_equal_the_jax_tools(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_bench_production", os.path.join(REPO, "tools",
                                             "bench_production.py"))
    jbp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbp)
    monkeypatch.setattr(jbp, "NCELLS", 2000)
    monkeypatch.setattr(jbp, "NZ", 3)
    dj = jbp.build_inputs(str(tmp_path / "jax"))
    dt = bp.build_inputs(str(tmp_path / "port"), ncells=2000, nz=3)
    for name in ("diag.nc", "hist.nc"):
        with open_dataset(os.path.join(dj, name)) as a, \
                open_dataset(os.path.join(dt, name)) as b:
            fields = [v for v in a.var_names() if v != "xtime"]
            assert fields and fields == [v for v in b.var_names()
                                         if v != "xtime"]
            for v in fields:
                x, y = np.array(a.read_var(v)), np.array(b.read_var(v))
                # f4 in both (big-endian in the classic file)
                assert x.dtype.str[1:] == y.dtype.str[1:] == "f4", v
                assert np.array_equal(x, y), v
    for name in ("diaglist", "histlist_2d", "histlist_3d", "histlist_soil"):
        with open(os.path.join(dj, "parm", name)) as a, \
                open(os.path.join(dt, "parm", name)) as b:
            assert a.read() == b.read(), name


def test_streamed_output_within_the_jax_bound(netcdf4_run, tmp_path):
    _, d, files = netcdf4_run
    cfg = JaxConfig.from_namelist(os.path.join(d, "namelist.rss_streamed"))
    cfg.output_file = str(tmp_path / "jax.nc")
    cfg.weights_cache_dir = str(tmp_path / "jax_weights")
    jax_run(cfg, jnp.float32)
    with open_dataset(cfg.output_file) as fj, \
            open_dataset(files["streamed"]) as ft:
        assert ft.var_names() == fj.var_names()
        for v in fj.var_names():
            x, y = ft.read_var(v), fj.read_var(v)
            assert x.shape == y.shape and x.dtype == y.dtype, v
            if x.dtype.kind == "f":
                fin = np.isfinite(y) & (np.abs(y) < 9e36)
                bound = 1e-5 * max(1.0, float(np.abs(y[fin]).max(initial=0)))
                assert np.abs(x[fin] - y[fin]).max(initial=0) <= bound, v
            else:
                np.testing.assert_array_equal(x, y, err_msg=v)


def test_cuda_platform_without_a_card_exits_before_any_work(tmp_path,
                                                            monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("MPASSIT_PLATFORM", raising=False)
    assert bp.main(["--writer", "digest", "--cache-dir",
                    str(tmp_path)] + ARGS) == 1
    assert os.listdir(tmp_path) == []


def test_nothing_written_to_the_root_artifact(netcdf4_run, digest_run,
                                              root_before):
    assert _root_state() == root_before
