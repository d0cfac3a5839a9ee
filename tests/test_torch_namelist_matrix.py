"""The namelist-path matrix through the port against the JAX package: each
case puts the same namelist (tests/test_pipeline.make_case) through
mpassit_tpu.run.pipeline.run_pipeline and through the port's
run_pipeline(..., device="cpu"), and compares every RegridResult array
(f32 within 1e-5 * max(1, max|ref|), tests/test_torch_pipeline.py's bound)
and the output files' variables, dims and attributes.

- The file-path target (target_grid_type = "file"): the target file is a
  first run's output, whose HGT is regridded again under interp_hist; a
  diag-only run takes the file's HGT, in memory and streamed (the
  streamed HGT put); a target file written by netCDF-C (superblock 2,
  deflated) read by the port with h5py blocked, its TargetGrid bit for
  bit the port's read of it through h5py.
- Mercator, polar stereographic and regional lat-lon targets with
  wrf_mod_vars = .false. and interp_hist = .true.: no SINALPHA, the winds
  present and not rotated, and the packed apply made with no rotation
  window.
- The global lat-lon target (Q9) of tests/test_global_latlon.py, with
  that file's seam and conservative row-sum checks on the port's result.
- The ROTLL exclusion: a target file with MAP_PROJ = 203 and no XLAT_U
  fails in the port with the JAX package's exception type and message."""

import copy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.config import Config
from mpassit_tpu.io.nc4 import open_dataset
from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.grids.target import target_grid_from_file
from mpassit_tpu_torch.io import hdf5, nc4
from mpassit_tpu_torch.ops import packed_kernel as pk
from mpassit_tpu_torch.run import pipeline as tpipe

import nc4_foreign as nf
from test_global_latlon import NX, NY
from test_pipeline import make_case, smooth
from test_torch_pipeline import _arrays, _assert_results_close, _port

needs_netcdf_c = pytest.mark.skipif(
    nf.libnetcdf() is None, reason="system libnetcdf not present")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_files_match(port_file, jax_file):
    """test_torch_pipeline.test_output_file_matches_jax's checks: the same
    variables, global attributes, dims and attribute names of each
    variable, floats within 1e-5 * max(1, max|ref|), the rest equal. T is
    the regridded theta less 300 (quirk Q7), so its bound is theta's, the
    RegridResult array it is written from."""
    with open_dataset(jax_file) as fj, open_dataset(port_file) as ft:
        assert ft.var_names() == fj.var_names()
        assert ft.global_attr_names() == fj.global_attr_names()
        for a in fj.global_attr_names():
            assert str(ft.get_attr(a)) == str(fj.get_attr(a)), a
        for v in fj.var_names():
            assert ft.var_dims(v) == fj.var_dims(v), v
            assert ft.var_attrs(v).keys() == fj.var_attrs(v).keys(), v
            x, y = ft.read_var(v), fj.read_var(v)
            assert x.shape == y.shape and x.dtype == y.dtype, v
            if x.dtype.kind == "f":
                fin = np.isfinite(y) & (np.abs(y) < 9e36)
                ref = y[fin] + (300.0 if v == "T" else 0.0)
                bound = 1e-5 * max(1.0, float(np.abs(ref).max(initial=0)))
                assert np.abs(x[fin] - y[fin]).max(initial=0) <= bound, v
            else:
                np.testing.assert_array_equal(x, y, err_msg=v)


def _both(jcfg, tag):
    """(JAX run, port run) of one namelist, each writing its own file;
    the port's config is copied before the JAX run changes ``jcfg``."""
    pcfg = _port(copy.deepcopy(jcfg))
    pcfg.output_file = jcfg.output_file.replace(".nc", f"_{tag}_port.nc")
    ref = jax_run(jcfg, jnp.float32)
    got = tpipe.run_pipeline(pcfg, device="cpu")
    return ref, got


def _file_cfg(cfg, d, target, name, **kw):
    return Config.from_dict({
        "grid_file_input_grid": cfg.grid_file_input_grid,
        "diag_file_input_grid": cfg.diag_file_input_grid,
        "hist_file_input_grid": cfg.hist_file_input_grid,
        "output_file": str(d / f"{name}.nc"),
        "interp_diag": True, "interp_hist": True, "wrf_mod_vars": True,
        "target_grid_type": "file", "file_target_grid": target,
        "varlist_dir": str(d), **kw})


# ---- the file-path target --------------------------------------------------

@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """A Lambert params run of the JAX package: its output is the target
    file of the second runs."""
    d = tmp_path_factory.mktemp("filetarget")
    mesh, cfg, _, _ = make_case(d, nx=16, ny=12)
    art = jax_run(cfg, jnp.float32)
    return d, cfg, art


def test_file_target_matches_jax(first_run):
    """interp_hist: the file's HGT is regridded again ('ter'), and the
    grid and the config's projection come from the file."""
    d, cfg, art1 = first_run
    jcfg = _file_cfg(cfg, d, cfg.output_file, "file_hist")
    ref, got = _both(jcfg, "hist")
    _assert_results_close(got.result, ref.result)
    g, r = got.grid, ref.grid
    assert (g.nx, g.ny, g.proj_code) == (r.nx, r.ny, r.proj_code)
    for f in ("lat", "lon", "lat_u", "lon_v", "mapfac_m", "sina", "cosa",
              "lat_corner", "lon_corner", "hgt"):
        np.testing.assert_array_equal(getattr(g, f), getattr(r, f),
                                      err_msg=f)
    assert got.cfg.proj_code == 1 and got.cfg.truelat1 == pytest.approx(38.5)
    assert got.cfg.map_proj_char == "Lambert Conformal"
    # HGT regridded again, not the file's (interp.F90:226-238)
    assert not np.array_equal(got.result.hgt, g.hgt.astype(np.float32))
    _assert_files_match(got.cfg.output_file, ref.cfg.output_file)


@pytest.mark.parametrize("stream", [False, True])
def test_file_target_diag_only_takes_the_files_hgt(first_run, stream):
    """A diag-only run writes the target file's HGT: in memory, and
    streamed (the writer's HGT put of the file's field)."""
    d, cfg, _ = first_run
    jcfg = _file_cfg(cfg, d, cfg.output_file, f"file_diag_{stream}",
                     interp_hist=False, wrf_mod_vars=False,
                     stream_output=stream)
    ref, got = _both(jcfg, "diag")
    _assert_results_close(got.result, ref.result)
    np.testing.assert_array_equal(got.result.hgt, got.grid.hgt)
    _assert_files_match(got.cfg.output_file, ref.cfg.output_file)
    with nc4.open_dataset(got.cfg.output_file) as f:
        np.testing.assert_array_equal(
            f.read_var("HGT")[0], got.grid.hgt.astype(np.float32))


_GRID_FIELDS = ("lat", "lon", "lat_u", "lon_u", "lat_v", "lon_v",
                "mapfac_m", "mapfac_u", "mapfac_v", "sina", "cosa", "hgt",
                "lat_corner", "lon_corner")


@needs_netcdf_c
def test_netcdf_c_target_file(first_run, monkeypatch):
    """A wrfout-style target written by netCDF-C (superblock 2, deflate
    and shuffle, dense attributes): the port's read with h5py blocked is
    its read through h5py bit for bit, and the whole run matches the JAX
    package's run on the same file."""
    d, cfg, art1 = first_run
    target = str(d / "wrf_target_ncc.nc")
    nf.write_wrf_target(target, art1.grid, art1.cfg,
                        hgt=np.asarray(art1.result.hgt, np.float64))
    with open(target, "rb") as f:
        assert f.read(9)[8] == 2
    via_h5py = target_grid_from_file(target)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "h5py", None)
        with nc4.NetCDF4File(target) as f:
            assert isinstance(f._f, hdf5._Reader)
        ours = target_grid_from_file(target)
    assert (ours.nx, ours.ny, ours.proj_code) == \
        (via_h5py.nx, via_h5py.ny, via_h5py.proj_code)
    for f in _GRID_FIELDS:
        a, b = getattr(ours, f), getattr(via_h5py, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    jcfg = _file_cfg(cfg, d, target, "file_ncc")
    pcfg = _port(copy.deepcopy(jcfg))
    pcfg.output_file = str(d / "file_ncc_port.nc")
    ref = jax_run(jcfg, jnp.float32)
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "h5py", None)
        got = tpipe.run_pipeline(pcfg, device="cpu")
    _assert_results_close(got.result, ref.result)
    _assert_files_match(got.cfg.output_file, ref.cfg.output_file)


# ---- mercator, polar, regional lat-lon -------------------------------------

@pytest.mark.parametrize("proj,extra", [
    ("mercator", {"truelat1": 20.0}),
    ("polar", {"truelat1": 60.0}),
    ("lat-lon", {"is_regional": True}),
])
def test_non_lambert_matches_jax(tmp_path, monkeypatch, proj, extra):
    mesh, cfg, _, _ = make_case(tmp_path, nx=15, ny=11, wrf_mod_vars=False)
    d = {
        "grid_file_input_grid": cfg.grid_file_input_grid,
        "diag_file_input_grid": cfg.diag_file_input_grid,
        "hist_file_input_grid": cfg.hist_file_input_grid,
        "output_file": str(tmp_path / f"out_{proj}.nc"),
        "interp_diag": True, "interp_hist": True, "wrf_mod_vars": False,
        "target_grid_type": proj, "nx": 16, "ny": 12,
        "ref_lat": 38.5, "ref_lon": -97.5, "stand_lon": -97.5,
        "varlist_dir": str(tmp_path),
        **({"dx": 2.0, "dy": 2.0} if proj == "lat-lon"
           else {"dx": 250e3, "dy": 250e3}), **extra}
    windows = []
    plain = pk.packed_apply_plain

    def recorded(*a, **kw):
        windows.append(tuple(kw.get("rotate", ())))
        return plain(*a, **kw)
    monkeypatch.setattr(pk, "packed_apply_plain", recorded)
    ref, got = _both(Config.from_dict(d), proj)
    _assert_results_close(got.result, ref.result)
    _assert_files_match(got.cfg.output_file, ref.cfg.output_file)
    # every packed apply (plain on the CPU) made with no rotation window
    assert windows and not any(windows), windows
    with nc4.open_dataset(got.cfg.output_file) as f:
        assert f.get_attr("MAP_PROJ") == got.cfg.proj_code
        assert not f.has_var("SINALPHA")
        u = f.read_var("U")[0]
        assert abs(u[0, :, 1:-1].mean() - 15.0) < 1.0     # not rotated
        assert f.has_var("V")


# ---- global lat-lon (Q9) ---------------------------------------------------

@pytest.fixture(scope="module")
def global_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("global_port")
    mesh, cfg, _, _ = make_case(
        d, ncells=3000,
        cfg_overrides={
            "target_grid_type": "lat-lon", "is_regional": False,
            "nx": NX + 1, "ny": NY + 1, "dx": None, "dy": None,
            "ref_lat": None, "ref_lon": None, "truelat1": None,
            "stand_lon": 0.0})
    return _both(cfg, "global")


def test_global_latlon_matches_jax(global_runs):
    ref, got = global_runs
    assert got.grid.lat.shape == (NY, NX)
    _assert_results_close(got.result, ref.result)
    _assert_files_match(got.cfg.output_file, ref.cfg.output_file)
    for name, arr in _arrays(got.result).items():
        assert np.isfinite(arr).all(), name


def test_global_latlon_seam_and_rows(global_runs):
    """tests/test_global_latlon.py's seam, row-sum and accuracy checks on
    the port's result and the port's conservative weights."""
    from mpassit_tpu_torch.weights.conservative import conservative_weights

    _, got = global_runs
    t2 = dict((n, a) for n, a, *_ in got.result.diag2d)["T2"]
    seam = np.abs(t2[:, 0] - t2[:, -1]).max()
    assert seam <= 1.5 * np.abs(np.diff(t2, axis=1)).max() + 1e-9
    sums = conservative_weights(got.mesh, got.grid).row_sums().reshape(
        NY, NX)
    np.testing.assert_allclose(sums, 1.0, atol=5e-3)
    for edge in (sums[0, :], sums[-1, :], sums[:, 0]):
        np.testing.assert_allclose(edge, 1.0, atol=5e-3)
    err = np.abs(t2 - (280.0 + 5.0 * smooth(got.grid.lat, got.grid.lon)))
    assert err.mean() < 0.1 and err.max() < 1.0


# ---- the ROTLL exclusion ---------------------------------------------------

def test_rotll_target_fails_as_in_jax(tmp_path):
    """MAP_PROJ = 203 (rotated lat-lon) with no XLAT_U: the JAX package
    raises NetCDFError("reading XLAT_U id", ...) from reading the target
    file; the port raises the same."""
    mesh, cfg, _, _ = make_case(tmp_path, nx=8, ny=6)
    target = str(tmp_path / "rotll.nc")
    ny, nx = 6, 8
    lat, lon = np.meshgrid(np.linspace(30, 40, ny), np.linspace(-100, -90,
                                                                 nx),
                           indexing="ij")
    with nc4.NetCDF4File(target, "w") as f:
        f.create_dim("Time", None)
        f.ensure_unlimited_size("Time", 1)
        f.create_dim("south_north", ny)
        f.create_dim("west_east", nx)
        for name, a in (("XLAT", lat), ("XLONG", lon), ("HGT", lat * 0)):
            f.create_var(name, ("Time", "south_north", "west_east"), "f4",
                         data=a[None].astype(np.float32))
        f.set_attr("DX", 10000.0)
        f.set_attr("MAP_PROJ", 203)
        f.set_attr("CEN_LAT", 35.0)
        f.set_attr("CEN_LON", -95.0)
    jcfg = _file_cfg(cfg, tmp_path, target, "rotll")
    pcfg = _port(copy.deepcopy(jcfg))
    with pytest.raises(Exception) as want:
        jax_run(jcfg, jnp.float32)
    with pytest.raises(Exception) as got:
        tpipe.run_pipeline(pcfg, device="cpu")
    assert type(want.value).__name__ == "NetCDFError"
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert got.value.banner() == want.value.banner()
    assert "reading XLAT_U id" in str(got.value)
