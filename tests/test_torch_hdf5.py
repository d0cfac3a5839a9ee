"""The port's HDF5 encoder and reader (mpassit_tpu_torch/io/hdf5.py), which
write and read its NetCDF4 files with no h5py.

- The same write_output inputs (in-memory and streamed) through the
  encoder and through h5py (the writer as it was, kept here only): every
  variable bit for bit, every attribute the same value and netCDF type,
  through libnetcdf (io/netcdf_c) the same dim ids and order and the same
  variable order.
- The port's CLI file, written with h5py blocked from import, against the
  JAX package's file (h5py) on the same inputs, at the six checks of
  tests/test_netcdf_c_interop.py.
- With h5py blocked, a whole CLI run and a streamed run write and read
  back through the port's reader; a CLI process writes without ever
  importing h5py.
- An h5py ``r+`` edit of a port file, the reader's refusals (each naming
  the structure), offsets past 4 GiB in a sparse file, concurrent writes
  from more threads than cores, lookup3's published test vectors."""

import copy
import os
import subprocess
import sys
import threading

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.errors import FatalError
from mpassit_tpu_torch.io import hdf5, nc4, netcdf_c
from mpassit_tpu_torch.io import wrf_writer as t_writer
from mpassit_tpu_torch.run import pipeline as tpipe

from test_pipeline import make_case
from test_torch_pipeline import REPO, _port, _write_namelist

needs_libnetcdf = pytest.mark.skipif(
    not netcdf_c.available(), reason="system libnetcdf not present")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class H5pyNetCDF4File(nc4.NetCDF4File):
    """``NetCDF4File``'s write mode on an h5py file, as the port wrote
    before its own encoder: the yardstick of the encoder's bytes."""

    def __init__(self, path, mode="w"):
        self.path, self.mode = path, mode
        self._f = h5py.File(path, mode, track_order=True)
        self._f.attrs["_NCProperties"] = np.bytes_(
            b"version=2,netcdf=4.9.0,hdf5=1.10.8")
        self._dimids = {}

    def set_attr(self, name, value, var=None):
        if isinstance(value, str) and value == "":
            target = self._f if var is None else self._f[var]
            target.attrs[name] = h5py.Empty(np.dtype("S1"))
        else:
            super().set_attr(name, value, var)


def _copy_to_port(src, dst):
    """Rewrite a NetCDF4 file through the port's encoder: the same dims
    (``Time`` unlimited), variables, data and attributes, in order."""
    with nc4.NetCDF4File(src) as a, nc4.NetCDF4File(dst, "w") as b:
        for d in a.dim_names():
            b.create_dim(d, None if d == "Time" else a.dim_size(d))
            if d == "Time":
                b.ensure_unlimited_size("Time", a.dim_size(d))
        for k in a.global_attr_names():
            b.set_attr(k, a.get_attr(k))
        for v in a.var_names():
            data = a.read_var(v)
            b.create_var(v, a.var_dims(v), data.dtype, data=data)
            for k, val in a.var_attrs(v).items():
                b.set_attr(k, val, var=v)


def _nc_atts(nc, var=None):
    """[(name, netCDF type, length, value)] of every attribute, hidden ones
    included, in libnetcdf's order."""
    import ctypes

    varid = netcdf_c.NC_GLOBAL if var is None else nc._vars[var]
    n = ctypes.c_int()
    nc._lib.nc_inq_varnatts(nc.ncid, varid, ctypes.byref(n))
    out = []
    for name in nc._att_names(varid, n.value):
        xtype, ln = ctypes.c_int(), ctypes.c_size_t()
        assert nc._lib.nc_inq_att(nc.ncid, varid, name.encode(),
                                  ctypes.byref(xtype), ctypes.byref(ln)) == 0
        val = nc._att(varid, name)
        out.append((name, xtype.value, ln.value,
                    np.asarray(val).tolist()))
    return out


def _nc_inventory(path):
    """Everything libnetcdf numbers: dims (in id order, with sizes), the
    unlimited dim, variables (in id order, with dims and types) and every
    attribute with its type."""
    with netcdf_c.NetCDFCFile(path) as nc:
        return {
            "dims": [(d, nc.dim_size(d)) for d in nc.dim_names()],
            "unlimited": nc.unlimited_dim(),
            "vars": [(v, nc.var_dims(v), str(nc.var_dtype(v)))
                     for v in nc.var_names()],
            "global_atts": _nc_atts(nc),
            "var_atts": {v: _nc_atts(nc, v) for v in nc.var_names()},
        }


def _assert_same_variables(path_a, path_b):
    """Every variable of two files bit for bit, read through h5py."""
    with h5py.File(path_a) as a, h5py.File(path_b) as b:
        assert list(a) == list(b)
        for name in a:
            x, y = a[name], b[name]
            assert x.shape == y.shape and x.dtype == y.dtype, name
            if x.id.get_offset() is None and y.id.get_offset() is None:
                continue                      # dimension scales: fill
            np.testing.assert_array_equal(x[...], y[...], err_msg=name)
            if x.dtype.kind == "f":
                assert x[...].tobytes() == y[...].tobytes(), name


# ---- the encoder against h5py, same inputs --------------------------------

@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("hdf5case")
    mesh, cfg, hist, diag = make_case(d)
    return d, mesh, cfg


@pytest.mark.parametrize("mode", ["in_memory", "streamed"])
def test_encoder_matches_h5py(case, tmp_path, monkeypatch, mode):
    d, _, cfg = case
    port = _port(cfg)
    port.stream_output = mode == "streamed"
    port.output_file = str(tmp_path / "encoder.nc")
    art = tpipe.run_pipeline(port, device="cpu")
    ours = port.output_file
    theirs = str(tmp_path / "h5py.nc")
    monkeypatch.setattr(t_writer, "NetCDF4File", H5pyNetCDF4File)
    if mode == "in_memory":
        t_writer.write_output(theirs, art.cfg, art.grid, art.data, art.result)
    else:
        port.output_file = theirs
        tpipe.run_pipeline(port, device="cpu")
    _assert_same_variables(ours, theirs)
    if netcdf_c.available():
        assert _nc_inventory(ours) == _nc_inventory(theirs)


# ---- the port's CLI file (h5py blocked) against the JAX package's ---------

@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """(the JAX package's file, the port's CLI file written and read back
    with h5py blocked, its streamed twin, the port's inputs' dir)."""
    d = tmp_path_factory.mktemp("hdf5cli")
    mesh, jcfg, _, _ = make_case(d)
    # the JAX run moves the grid's centre into its config
    cfg = copy.deepcopy(jcfg)
    jax_run(jcfg, jnp.float32)
    port_in = d / "port"
    port_in.mkdir()
    for name in ("grid", "diag", "hist"):
        _copy_to_port(str(d / f"{name}.nc"), str(port_in / f"{name}.nc"))
    cfg.grid_file_input_grid = str(port_in / "grid.nc")
    cfg.diag_file_input_grid = str(port_in / "diag.nc")
    cfg.hist_file_input_grid = str(port_in / "hist.nc")
    files = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "h5py", None)
        mp.setenv("MPASSIT_PLATFORM", "cpu")
        for mode in ("in_memory", "streamed"):
            cfg.output_file = str(port_in / f"out_{mode}.nc")
            nml = port_in / f"namelist_{mode}.input"
            _write_namelist(cfg, nml)
            if mode == "streamed":
                nml.write_text(nml.read_text().replace(
                    "/\n", " stream_output = .true.\n/\n"))
            assert tpipe.main([str(nml)]) == 0
            with nc4.open_dataset(cfg.output_file) as f:
                assert isinstance(f._f, hdf5._Reader)
                files[mode] = (cfg.output_file, {
                    v: f.read_var(v) for v in f.var_names()})
    return str(d / "out.nc"), files, port_in


@pytest.mark.parametrize("mode", ["in_memory", "streamed"])
def test_cli_without_h5py_reads_back(cli_files, mode):
    """The port's reader gives what h5py reads from the same file, and the
    streamed file is the in-memory file."""
    _, files, _ = cli_files
    path, got = files[mode]
    with h5py.File(path) as f:
        for name, arr in got.items():
            np.testing.assert_array_equal(arr, f[name][...], err_msg=name)
            assert arr.dtype == f[name].dtype, name
    _assert_same_variables(files["in_memory"][0], path)


def test_cli_process_never_imports_h5py(tmp_path):
    """The CLI function, in-memory and streamed, on classic inputs, in a
    process where h5py is importable: it writes both NetCDF4 files and
    h5py is never imported."""
    script = r"""
import os, sys
import numpy as np
from mpassit_tpu_torch.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_tpu_torch.run import pipeline
from mpassit_tpu_torch.testing import (
    write_data_file_classic, write_grid_file_classic)
d = sys.argv[1]
mesh = synthetic_voronoi_mesh(ncells=600, nz=3, nsoil=2, seed=3)
write_grid_file_classic(mesh, os.path.join(d, "grid.nc"))
f2 = np.sin(np.deg2rad(mesh.lat_cell))
lev = np.linspace(0, 1, 3)
attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 60.0}
for name, fields in (("diag", {"u10": 5 + f2, "v10": 1 + f2}),
                     ("hist", {"skintemp": 285 + f2,
                               "theta": 300 + f2[:, None] + lev})):
    write_data_file_classic(mesh, os.path.join(d, name + ".nc"), fields,
                            attrs=attrs, xtime="2024-03-25_10:00:00")
for name, body in (("diaglist", "u10 U10\nv10 V10\n"),
                   ("histlist_2d", "skintemp TSK\n"),
                   ("histlist_3d", "theta T\n"), ("histlist_soil", "")):
    open(os.path.join(d, name), "w").write(body)
for stream in (".false.", ".true."):
    nml = os.path.join(d, "nml" + stream)
    open(nml, "w").write(f'''&config
 grid_file_input_grid = "{d}/grid.nc"
 diag_file_input_grid = "{d}/diag.nc"
 hist_file_input_grid = "{d}/hist.nc"
 output_file = "{d}/out{stream}nc"
 varlist_dir = "{d}"
 target_grid_type = "lambert"
 interp_diag = .true.
 interp_hist = .true.
 wrf_mod_vars = .true.
 stream_output = {stream}
 nx = 21
 ny = 16
 dx = 200000.0
 dy = 200000.0
 ref_lat = 38.5
 ref_lon = -97.5
 truelat1 = 38.5
 stand_lon = -97.5
/
''')
    assert pipeline.main([nml]) == 0
    assert open(f"{d}/out{stream}nc", "rb").read(8) == b"\x89HDF\r\n\x1a\n"
assert "h5py" not in sys.modules, "h5py was imported"
print("OK")
"""
    env = dict(os.environ, MPASSIT_PLATFORM="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
    _assert_same_variables(str(tmp_path / "out.false.nc"),
                           str(tmp_path / "out.true.nc"))


@needs_libnetcdf
def test_nc_open_and_inventory(cli_files):
    jax_file, files, _ = cli_files
    port_file = files["in_memory"][0]
    with netcdf_c.NetCDFCFile(port_file) as nc, \
            netcdf_c.NetCDFCFile(jax_file) as ref:
        for dim in ("Time", "west_east", "west_east_stag", "south_north",
                    "south_north_stag", "bottom_top", "bottom_top_stag",
                    "soil_layers_stag", "StrLen"):
            assert nc.has_dim(dim), dim
            assert nc.dim_size(dim) == ref.dim_size(dim), dim
        assert nc.unlimited_dim() == "Time"
        # the same dim ids and variable ids, in the same order
        assert nc.dim_names() == ref.dim_names()
        assert nc.dim_names()[0] == "Time"
        assert nc.var_names() == ref.var_names()


@needs_libnetcdf
def test_nc_var_dims_and_values(cli_files):
    jax_file, files, _ = cli_files
    port_file, back = files["in_memory"]
    with netcdf_c.NetCDFCFile(port_file) as nc, \
            netcdf_c.NetCDFCFile(jax_file) as ref:
        for name in nc.var_names():
            assert nc.var_dims(name) == ref.var_dims(name), name
            got, want = nc.read_var(name), ref.read_var(name)
            assert got.shape == want.shape == back[name].shape, name
            # libnetcdf reads what the port's reader reads
            assert got.tobytes() == back[name].tobytes(), name
            if got.dtype.kind == "S":
                assert (got == want).all(), name
            else:
                # tests/test_torch_pipeline.py's file bound on the port
                # against the JAX package
                bound = 1e-5 * max(1.0, float(np.abs(want).max()))
                err = float(np.abs(got.astype(np.float64) - want).max())
                assert err <= bound, (name, err, bound)


@needs_libnetcdf
def test_nc_global_attrs(cli_files):
    jax_file, files, _ = cli_files
    with netcdf_c.NetCDFCFile(files["in_memory"][0]) as nc, \
            netcdf_c.NetCDFCFile(jax_file) as ref:
        names = nc.global_attr_names()
        for key in ("WEST-EAST_GRID_DIMENSION", "DX", "MAP_PROJ",
                    "MAP_PROJ_CHAR", "TRUELAT1", "CEN_LAT", "START_DATE",
                    "POL_ELAT"):
            assert key in names, key
        assert "version=" in nc.get_attr("_NCProperties")
        # every attribute: same name, order, netCDF type, length and value
        assert _nc_atts(nc) == _nc_atts(ref)


@needs_libnetcdf
def test_nc_var_attrs_and_types(cli_files):
    jax_file, files, _ = cli_files
    with netcdf_c.NetCDFCFile(files["in_memory"][0]) as nc, \
            netcdf_c.NetCDFCFile(jax_file) as ref:
        t2 = nc.var_attrs("T2")
        assert t2["MemoryOrder"] == "XY "
        assert t2["stagger"] == ""
        assert nc.var_attrs("U")["stagger"] == "X"
        assert nc.var_attrs("V")["stagger"] == "Y"
        assert nc.var_dtype("T2") == np.float32
        assert nc.var_dtype("ITIMESTEP") == np.int32
        assert nc.var_dtype("Times") == np.dtype("S1")
        for name in nc.var_names():
            assert nc.var_dtype(name) == ref.var_dtype(name), name
            assert _nc_atts(nc, name) == _nc_atts(ref, name), name


@needs_libnetcdf
def test_nc_times_string(cli_files):
    jax_file, files, _ = cli_files
    with netcdf_c.NetCDFCFile(files["in_memory"][0]) as nc, \
            netcdf_c.NetCDFCFile(jax_file) as ref:
        times = nc.read_var("Times")
        assert times.shape[1] == 19
        s = b"".join(times[0].reshape(-1)).decode()
        assert s == "2024-03-25_10:00:00"
        assert (times == ref.read_var("Times")).all()


@needs_libnetcdf
def test_nc_reads_our_mpas_style_inputs(cli_files, tmp_path):
    """The port's synthetic MPAS grid file is real netCDF, the same as the
    JAX package's writer makes of the same mesh."""
    from mpassit_tpu.mesh.synthetic import write_mpas_grid_file as j_write
    from mpassit_tpu_torch.mesh.synthetic import (
        synthetic_voronoi_mesh, write_mpas_grid_file)

    mesh = synthetic_voronoi_mesh(ncells=300, nz=3, nsoil=2, seed=11)
    path, ref = str(tmp_path / "grid.nc"), str(tmp_path / "grid_jax.nc")
    write_mpas_grid_file(mesh, path)
    j_write(mesh, ref)
    with netcdf_c.NetCDFCFile(path) as nc:
        assert nc.dim_size("nCells") == mesh.ncells
        voc = nc.read_var("verticesOnCell")
        assert voc.shape == (mesh.ncells, mesh.max_edges)
        lat = nc.read_var("latCell")
        np.testing.assert_allclose(np.rad2deg(lat), mesh.lat_cell, atol=1e-10)
    got, want = _nc_inventory(path), _nc_inventory(ref)
    assert got == want
    with netcdf_c.NetCDFCFile(path) as a, netcdf_c.NetCDFCFile(ref) as b:
        for name in a.var_names():
            assert a.read_var(name).tobytes() == b.read_var(name).tobytes()
    # the CLI's inputs, rewritten by the encoder, read the same too
    _, _, port_in = cli_files
    for name in ("grid.nc", "diag.nc", "hist.nc"):
        assert _nc_inventory(str(port_in / name)) == _nc_inventory(
            str(port_in.parent / name)), name


# ---- h5py edits, refusals, large offsets, threads, checksums ---------------

def test_h5py_r_plus_edit_of_a_port_file(cli_files, tmp_path):
    import shutil

    _, files, _ = cli_files
    path = str(tmp_path / "edited.nc")
    shutil.copy(files["in_memory"][0], path)
    with h5py.File(path, "r+") as f:
        t = f["T"][...]
        t[0, 1, 2, 3] += 1.0
        f["T"][...] = t
        f["T2"].attrs["extra"] = np.int32(7)
    with h5py.File(path) as f:
        np.testing.assert_array_equal(f["T"][...], t)
    back = hdf5.open_file(path)
    try:
        np.testing.assert_array_equal(back["T"][...], t)
    finally:
        back.close()
    if netcdf_c.available():
        with netcdf_c.NetCDFCFile(path) as nc:
            np.testing.assert_array_equal(nc.read_var("T"), t)
            assert nc.var_attrs("T2")["extra"] == 7


def _fixed_array_index(path):
    """A chunked dataset of libver "latest": layout 4, fixed-array
    chunk index."""
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(100.0), chunks=(10,))


def _lzf(path):
    with h5py.File(path, "w", track_order=True) as f:
        f.create_dataset("x", data=np.arange(100.0), compression="lzf")


def _huge_attribute(path):
    """Dense attributes, one of them past the heap's 4-KiB managed object
    size: a huge object."""
    with h5py.File(path, "w", track_order=True) as f:
        for i in range(12):
            f.attrs[f"a{i}"] = np.int32(i)
        f.attrs["big"] = np.arange(2000.0)


def _bad_fletcher32(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(64, dtype="i4"), chunks=(64,),
                         fletcher32=True)
        at = f["x"].id.get_chunk_info(0).byte_offset + 17
    with open(path, "r+b") as fh:
        fh.seek(at)
        b = fh.read(1)
        fh.seek(at)
        fh.write(bytes([b[0] ^ 4]))


def _user_block(path):
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("x", data=np.arange(3.0))


def _corrupt_header(path):
    with nc4.NetCDF4File(path, "w") as f:
        f.create_dim("n", 3)
        f.create_var("x", ("n",), "f4", data=np.arange(3.0))
    with open(path, "r+b") as fh:
        raw = fh.read()
        at = raw.rindex(b"OHDR") + 40
        fh.seek(at)
        fh.write(bytes([raw[at] ^ 1]))


@pytest.mark.parametrize("make,word", [
    (_fixed_array_index, "CHUNK INDEX TYPE 3 .FIXED ARRAY"),
    (_lzf, "FILTER 32000 .LZF"),
    (_huge_attribute, "HUGE OBJECT"),
    (_bad_fletcher32, "FLETCHER32 CHECKSUM MISMATCH"),
    (_user_block, "NO HDF5 SUPERBLOCK AT OFFSET 0"),
    (_corrupt_header, "CHECKSUM MISMATCH"),
])
def test_reader_refuses_what_it_does_not_parse(tmp_path, make, word):
    path = str(tmp_path / "f.h5")
    make(path)
    with pytest.raises(FatalError, match=word):
        f = hdf5.open_file(path)
        try:
            for _, ds in f.items():
                ds[...]
        finally:
            f.close()


@pytest.mark.parametrize("call", ["compress", "exists", "append",
                                  "attr_type"])
def test_encoder_refuses_what_it_does_not_store(tmp_path, call):
    with nc4.NetCDF4File(str(tmp_path / "f.nc"), "w") as f:
        f.create_dim("Time", None)
        f.create_dim("n", 3)
        with pytest.raises(FatalError):
            if call == "compress":
                f.create_var("x", ("n",), "f4", data=np.ones(3),
                             compress=True)
            elif call == "exists":
                f.create_var("n", ("n",), "f4")
            elif call == "append":
                f._f["Time"][...] = np.ones(1)
            else:
                f.set_attr("names", ["a", "b"])


def test_offsets_past_4gib(tmp_path):
    """A variable whose data starts past 4 GiB, behind a 4.8-GB variable
    written only at its end (a sparse file), and the metadata past both."""
    path = str(tmp_path / "big.nc")
    nbig = 1_200_000_000
    small = np.arange(12, dtype=np.float32).reshape(1, 12) + 0.25
    with nc4.NetCDF4File(path, "w") as f:
        f.create_dim("Time", None)
        f.ensure_unlimited_size("Time", 1)
        f.create_dim("big", nbig)
        f.create_dim("m", 12)
        f.create_var("tail", ("Time", "big"), "f4")
        f.write_var_slab("tail", np.full((1, 4), 7.0, np.float32),
                         (0, nbig - 4))
        f.create_var("small", ("Time", "m"), "f4", data=small)
        f.set_attr("units", "K", var="small")
    if os.stat(path).st_blocks * 512 > 64 * 2 ** 20:
        os.remove(path)
        pytest.skip("the filesystem made no sparse file")
    assert os.path.getsize(path) > 4 * nbig
    with h5py.File(path) as f:
        assert f["small"].id.get_offset() > 2 ** 32
        np.testing.assert_array_equal(f["small"][...], small)
        np.testing.assert_array_equal(f["tail"][0, -4:], 7.0)
    f = hdf5.open_file(path)
    try:
        kind, addr = f["small"]._layout()
        assert kind == "contiguous" and addr > 2 ** 32
        np.testing.assert_array_equal(f["small"][...], small)
        assert f["small"].attrs["units"] == b"K"
    finally:
        f.close()
    if netcdf_c.available():
        with netcdf_c.NetCDFCFile(path) as nc:
            np.testing.assert_array_equal(nc.read_var("small"), small)


def test_writes_from_more_threads_than_cores(tmp_path):
    """Each thread allocates and writes its own variables level by level
    while the others do: every level lands where it belongs."""
    path = str(tmp_path / "threads.nc")
    nthreads, nvars, nlev = 4 * (os.cpu_count() or 1), 3, 5
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []
    try:
        with nc4.NetCDF4File(path, "w") as f:
            f.create_dim("lev", nlev)
            f.create_dim("n", 64)
            names = [f"v{t}_{k}" for t in range(nthreads)
                     for k in range(nvars)]
            for name in names:
                f.create_var(name, ("lev", "n"), "f4")

            def work(t):
                try:
                    for lev in range(nlev):
                        for k in range(nvars):
                            val = np.full((1, 64), t * 100 + k * 10 + lev,
                                          np.float32)
                            f.write_var_slab(f"v{t}_{k}", val, (lev, 0))
                except BaseException as e:     # reported by the test
                    errors.append(e)
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(nthreads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
                assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    f = hdf5.open_file(path)
    try:
        for t in range(nthreads):
            for k in range(nvars):
                want = (t * 100 + k * 10
                        + np.arange(nlev, dtype=np.float32))[:, None]
                np.testing.assert_array_equal(
                    f[f"v{t}_{k}"][...], np.broadcast_to(want, (nlev, 64)))
    finally:
        f.close()


@pytest.mark.parametrize("data,initval,want", [
    (b"", 0, 0xDEADBEEF),
    (b"", 0xDEADBEEF, 0xBD5B7DDE),
    (b"Four score and seven years ago", 0, 0x17770551),
    (b"Four score and seven years ago", 1, 0xCD628161),
])
def test_lookup3_vectors(data, initval, want):
    """Bob Jenkins' published test vectors of hashlittle (lookup3.c)."""
    assert hdf5.lookup3(data, initval) == want


def test_lookup3_matches_h5py_headers(tmp_path):
    """The checksum h5py stored in a version-2 object header it wrote."""
    path = str(tmp_path / "h.h5")
    with h5py.File(path, "w", track_order=True) as f:
        f.attrs["a"] = np.int32(1)
        f.create_dataset("x", data=np.arange(5.0), track_order=True)
    raw = open(path, "rb").read()
    n = 0
    at = raw.find(b"OHDR")
    while at >= 0:
        flags = raw[at + 5]
        p = at + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        w = 1 << (flags & 3)
        end = p + w + int.from_bytes(raw[p:p + w], "little")
        assert hdf5.lookup3(raw[at:end]) == int.from_bytes(
            raw[end:end + 4], "little")
        n += 1
        at = raw.find(b"OHDR", end)
    assert n == 2
