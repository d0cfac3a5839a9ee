"""The port's classic-format reader (mpassit_tpu_torch/io/nc4._CDFReader).

- CDF-1 and CDF-2 files read with h5py blocked from import: the classic
  path needs neither h5py nor scipy.
- Variable for variable and attribute for attribute, it returns what the
  scipy-based reader of the JAX package (``mpassit_tpu.io.nc4
  ._ClassicReader``, the port's reader before this parser) returns, on
  files written by ``mpassit_tpu_torch/testing.py``: fixed and record
  ``Time``, CDF-1 and CDF-2, char, short, int, float and double; and what
  the JAX package's CDF-5 parser returns on a CDF-5 file libnetcdf wrote.
- Record data past 2 GiB: a sparse CDF-2 file whose second record starts
  past the 2-GiB mark reads its small record variable there (a few MB of
  real disk; skipped where the filesystem cannot make sparse files).
"""

import importlib.util
import os
import struct
import sys

import numpy as np
import pytest

from mpassit_tpu.io.nc4 import _CDF5Reader, _ClassicReader
from mpassit_tpu_torch.fields.registry import build_routing
from mpassit_tpu_torch.io import nc4
from mpassit_tpu_torch.io.mpas_reader import InputData, read_hist_data
from mpassit_tpu_torch.mesh.mpas import mesh_from_file
from mpassit_tpu_torch.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_tpu_torch.testing import (
    write_data_file_classic,
    write_grid_file_classic,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTRS = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 20.0,
         "output_interval": 60, "levels": np.array([1, -2, 3], np.int16),
         "weights": np.array([0.25, 1.5], np.float32),
         "config_lsm_scheme": "noah"}


@pytest.fixture(scope="module")
def mesh():
    return synthetic_voronoi_mesh(ncells=300, nz=3, nsoil=2, seed=3)


def _write_files(mesh, d, version, record_time):
    """A grid file (int, double) and one data file per field type (float,
    double, short, int), each with the char xtime; returns their paths."""
    kw = dict(version=version, record_time=record_time)
    paths = [os.path.join(d, "grid.nc")]
    write_grid_file_classic(mesh, paths[0], **kw)
    f2 = np.sin(np.deg2rad(mesh.lat_cell)) * 40
    lev = np.linspace(0, 1, mesh.nz)
    for dtype in ("f4", "f8", "i2", "i4"):
        paths.append(os.path.join(d, f"data_{dtype}.nc"))
        write_data_file_classic(
            mesh, paths[-1],
            {"t2m": 280 + f2, "theta": 300 + f2[:, None] + lev,
             "w": 1 + f2[:, None] + np.linspace(0, 1, mesh.nzp1),
             "tslb": 275 + f2[:, None] + np.linspace(0, 1, mesh.nsoil),
             "vort": np.cos(np.deg2rad(mesh.lat_vertex))[:, None] + lev},
            attrs=ATTRS, xtime="2024-03-25_10:00:00", dtype=dtype, **kw)
    return paths


def assert_same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert (a.dtype, a.shape) == (b.dtype, b.shape), what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def assert_readers_agree(got, ref):
    """Every dimension, variable and attribute of two readers' views of
    one file: equal values of equal types, arrays byte for byte."""
    assert got.dim_names() == ref.dim_names()
    for name in ref.dim_names():
        assert got.has_dim(name)
        assert_same(got.dim_size(name), ref.dim_size(name), name)
    assert got.var_names() == ref.var_names()
    for name in ref.var_names():
        assert got.has_var(name) and got.var_dims(name) == ref.var_dims(name)
        assert_same(got.read_var(name), ref.read_var(name), name)
        ga, ra = got.var_attrs(name), ref.var_attrs(name)
        assert list(ga) == list(ra), name
        for k in ra:
            assert_same(ga[k], ra[k], f"{name}.{k}")
    assert got.global_attr_names() == ref.global_attr_names()
    for k in ref.global_attr_names():
        assert_same(got.get_attr(k), ref.get_attr(k), k)
    assert got.get_attr("no_such_attr", None) is None
    with pytest.raises(KeyError):
        got.get_attr("no_such_attr")


@pytest.mark.parametrize("version", [1, 2])
def test_classic_read_needs_no_h5py(mesh, tmp_path, monkeypatch, version):
    """A whole classic read (mesh, history fields, attributes) with h5py
    blocked from import."""
    d = str(tmp_path)
    grid, *_ = _write_files(mesh, d, version, True)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    got = mesh_from_file(grid)
    assert got.ncells == mesh.ncells and got.nz == mesh.nz
    for name, body in (("histlist_2d", "t2m T2\n"),
                       ("histlist_3d", "theta T\n"), ("histlist_soil", "")):
        with open(os.path.join(d, name), "w") as f:
            f.write(body)
    data = InputData()
    read_hist_data(os.path.join(d, "data_f4.nc"),
                   build_routing(d, False, True, False), data)
    assert data.fields["theta"].shape == (mesh.ncells, mesh.nz)
    with nc4.open_dataset(os.path.join(d, "data_i2.nc")) as f:
        assert isinstance(f, nc4._CDFReader) and f.version == version
        assert f.dim_size("Time") == 1
        assert f.var_attrs("theta") == {"units": "si",
                                        "long_name": "theta field"}
        assert f.get_attr("config_start_time") == "2024-03-25_09:00:00"


@pytest.mark.parametrize("record_time", [True, False])
@pytest.mark.parametrize("version", [1, 2])
def test_classic_reader_matches_scipy_reader(mesh, tmp_path, version,
                                             record_time):
    for path in _write_files(mesh, str(tmp_path), version, record_time):
        with nc4.open_dataset(path) as got, _ClassicReader(path) as ref:
            assert isinstance(got, nc4._CDFReader)
            assert got.version == version
            assert_readers_agree(got, ref)


def test_cdf5_reader_unchanged(tmp_path):
    """On a CDF-5 file written by libnetcdf (tests/test_nc4_cdf5.py's
    writer), the port's parser returns what the JAX package's CDF-5
    parser returns."""
    from mpassit_tpu.io import netcdf_c

    if not netcdf_c.available():
        pytest.skip("system libnetcdf not found")
    spec = importlib.util.spec_from_file_location(
        "_cdf5_writer", os.path.join(REPO, "tests", "test_nc4_cdf5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = tmp_path / "h.nc"
    mod._write_mpas_like_cdf5(path)
    with nc4.open_dataset(str(path)) as got, _CDF5Reader(str(path)) as ref:
        assert isinstance(got, nc4._CDFReader) and got.version == 5
        assert_readers_agree(got, ref)


# ---------------------------------------------------- record data > 2 GiB ----

def _cdf2_header(nbig, nsmall, numrecs):
    """A CDF-2 header: dims Time (record), big, small; record variables
    ``big`` (Time, big) and ``small`` (Time, small), f4, after a fixed
    int ``flag`` (small,). Returns (header bytes, begin of flag, begin of
    big, begin of small, record size)."""
    i4 = lambda v: struct.pack(">i", v)  # noqa: E731
    i8 = lambda v: struct.pack(">q", v)  # noqa: E731

    def name(s):
        b = s.encode()
        return i4(len(b)) + b + b"\0" * (-len(b) % 4)

    def var(nm, dimids, vsize, begin, nct):
        return (name(nm) + i4(len(dimids)) + b"".join(map(i4, dimids))
                + i4(0) + i4(0) + i4(nct) + i4(vsize) + i8(begin))

    def build(begins):
        return (b"CDF\x02" + i4(numrecs)
                + i4(10) + i4(3) + name("Time") + i4(0) + name("big")
                + i4(nbig) + name("small") + i4(nsmall)
                + i4(0) + i4(0)
                + i4(11) + i4(3)
                + var("flag", [2], 4 * nsmall, begins[0], 4)
                + var("big", [0, 1], 4 * nbig, begins[1], 5)
                + var("small", [0, 2], 4 * nsmall, begins[2], 5))

    hlen = len(build([0, 0, 0]))
    begins = [hlen, hlen + 4 * nsmall, hlen + 4 * nsmall + 4 * nbig]
    return build(begins), *begins, 4 * nbig + 4 * nsmall


def test_record_data_past_2gib_reads(tmp_path):
    nbig, nsmall, numrecs = 300_000_000, 5, 2          # 1.2 GB per record
    head, b_flag, b_big, b_small, recsize = _cdf2_header(nbig, nsmall,
                                                         numrecs)
    path = str(tmp_path / "sparse.nc")
    size = b_big + numrecs * recsize
    small = np.arange(numrecs * nsmall, dtype=">f4").reshape(numrecs, -1)
    small += 0.5
    with open(path, "wb") as f:
        f.truncate(size)
        f.write(head)
        f.seek(b_flag)
        f.write(np.arange(nsmall, dtype=">i4").tobytes())
        for r in range(numrecs):
            f.seek(b_small + r * recsize)
            f.write(small[r].tobytes())
    if os.stat(path).st_blocks * 512 > 64 * 2 ** 20:
        os.remove(path)
        pytest.skip("the filesystem made no sparse file")
    assert b_small + recsize > 2 ** 31            # record 1 past 2 GiB
    with nc4.open_dataset(path) as f:
        assert isinstance(f, nc4._CDFReader) and f.version == 2
        assert f.dim_size("Time") == numrecs and f.dim_size("big") == nbig
        assert f.var_dims("small") == ["Time", "small"]
        got = f.read_var("small")
        assert got.dtype == np.dtype(">f4") and got.shape == (numrecs,
                                                             nsmall)
        np.testing.assert_array_equal(got, small)
        np.testing.assert_array_equal(f.read_var("flag"), np.arange(nsmall))
