"""NetCDF4 files written by the system netCDF-C library (through ctypes),
for the tests of the port's HDF5 reader on files it did not write, and the
generator of the committed fixtures in tests/data/nc4_foreign/.

    python tests/nc4_foreign.py            # rewrite the fixtures

``NCWriter`` is a thin binding of the write half of netCDF-C
(``nc_create(NC_NETCDF4)``, ``nc_def_dim/var``, ``nc_def_var_deflate``,
``_chunking``, ``_endian``, ``_fletcher32``, ``nc_put_att_*``,
``nc_put_vara``), as netcdf-fortran and PIO call it for MPAS and WRF
files and as the Fortran MPASSIT writes its output. ``write_mpas_case``
writes an MPAS mesh, diag and history file in MPAS's layout: ``Time``
unlimited (so every field is chunked under a v1 B-tree), deflate level 1
with shuffle, more than 8 global attributes (so they are stored dense),
``xtime`` as ``char(Time, StrLen)``. ``write_wrf_target`` writes a
wrfout-style target file, ``copy_through_netcdf_c`` rewrites a file as
netCDF-C writes it.

The fixtures (made by ``main``, at most 1 MB in all):

- ``wrf_lambert_target.nc``: a 150x100 Lambert target at 36 km over
  CONUS in WRF's variable set (XLAT, XLONG, XLAT_U/V, XLONG_U/V, MAPFAC_*,
  SINALPHA, COSALPHA, HGT, the map attributes), deflated, as WRF 4 writes
  a wrfout used as ``file_target_grid``;
- ``mpas_diag_tiny.nc``: a small MPAS-layout diag file, chunked and
  deflated, with big-endian, fletcher32 and a string attribute;
- ``manifest.json``: per file, every variable's dtype, shape and blake2b
  digest of its bytes as h5py reads them, and every attribute's value
  (``mpassit_tpu_torch.testing.describe_hdf5``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from mpassit_tpu_torch.testing import describe_hdf5  # noqa: E402

NC_NETCDF4, NC_CLOBBER, NC_UNLIMITED = 0x1000, 0, 0
NC_GLOBAL = -1
NC_CHUNKED, NC_CONTIGUOUS = 0, 1
NC_ENDIAN_BIG = 2
NC_FLETCHER32 = 1
_NCTYPE = {np.dtype("i1"): 1, np.dtype("S1"): 2, np.dtype("i2"): 3,
           np.dtype("i4"): 4, np.dtype("f4"): 5, np.dtype("f8"): 6,
           np.dtype("u1"): 7, np.dtype("u2"): 8, np.dtype("u4"): 9,
           np.dtype("i8"): 10, np.dtype("u8"): 11}

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "nc4_foreign")


def libnetcdf():
    """The system netCDF-C library, or None where it is absent."""
    for name in ("libnetcdf.so", "libnetcdf.so.19", "libnetcdf.so.18",
                 "libnetcdf.so.15", ctypes.util.find_library("netcdf")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.nc_strerror.restype = ctypes.c_char_p
        lib.nc_inq_libvers.restype = ctypes.c_char_p
        return lib
    return None


class NCWriter:
    """A NetCDF4 file written through netCDF-C."""

    def __init__(self, path):
        self.lib = libnetcdf()
        if self.lib is None:
            raise OSError("libnetcdf not found")
        ncid = ctypes.c_int()
        self._ok(self.lib.nc_create(path.encode(), NC_NETCDF4 | NC_CLOBBER,
                                    ctypes.byref(ncid)), "nc_create")
        self.ncid = ncid.value
        self.dims, self.vars = {}, {}

    def _ok(self, rc, what):
        if rc:
            raise OSError(f"{what}: {self.lib.nc_strerror(rc).decode()}")

    def def_dim(self, name, size):
        """``size`` None: unlimited."""
        d = ctypes.c_int()
        self._ok(self.lib.nc_def_dim(
            self.ncid, name.encode(),
            ctypes.c_size_t(NC_UNLIMITED if size is None else size),
            ctypes.byref(d)), f"nc_def_dim({name})")
        self.dims[name] = d.value

    def def_var(self, name, dtype, dims, deflate=None, shuffle=False,
                chunks=None, contiguous=False, big_endian=False,
                fletcher32=False, fill=None, szip=None):
        """``szip``: (options mask, pixels per block) for
        ``nc_def_var_szip`` (NC_SZIP_NN 32, NC_SZIP_EC 4)."""
        dt = np.dtype(dtype)
        v = ctypes.c_int()
        ids = (ctypes.c_int * max(len(dims), 1))(*[self.dims[d]
                                                   for d in dims])
        self._ok(self.lib.nc_def_var(self.ncid, name.encode(),
                                     _NCTYPE[dt.newbyteorder("=")],
                                     len(dims), ids, ctypes.byref(v)),
                 f"nc_def_var({name})")
        vid = self.vars[name] = v.value
        if contiguous:
            self._ok(self.lib.nc_def_var_chunking(self.ncid, vid,
                                                  NC_CONTIGUOUS, None),
                     "nc_def_var_chunking")
        elif chunks is not None:
            cs = (ctypes.c_size_t * len(chunks))(*chunks)
            self._ok(self.lib.nc_def_var_chunking(self.ncid, vid,
                                                  NC_CHUNKED, cs),
                     "nc_def_var_chunking")
        if deflate is not None or shuffle:
            self._ok(self.lib.nc_def_var_deflate(
                self.ncid, vid, int(shuffle), int(deflate is not None),
                deflate or 0), "nc_def_var_deflate")
        if szip is not None:
            self._ok(self.lib.nc_def_var_szip(self.ncid, vid, *szip),
                     "nc_def_var_szip")
        if fletcher32:
            self._ok(self.lib.nc_def_var_fletcher32(self.ncid, vid,
                                                    NC_FLETCHER32),
                     "nc_def_var_fletcher32")
        if big_endian:
            self._ok(self.lib.nc_def_var_endian(self.ncid, vid,
                                                NC_ENDIAN_BIG),
                     "nc_def_var_endian")
        if fill is not None:
            f = np.asarray(fill, dt.newbyteorder("="))
            self._ok(self.lib.nc_def_var_fill(
                self.ncid, vid, 0, f.ctypes.data_as(ctypes.c_void_p)),
                "nc_def_var_fill")

    def put_att(self, name, value, var=None):
        """str: NC_CHAR; a list of str: NC_STRING; else numeric, the
        value's own type (a Python int as NC_INT, a float as NC_DOUBLE)."""
        vid = NC_GLOBAL if var is None else self.vars[var]
        key = name.encode()
        if isinstance(value, str):
            raw = value.encode()
            self._ok(self.lib.nc_put_att_text(self.ncid, vid, key,
                                              ctypes.c_size_t(len(raw)),
                                              raw), f"put_att({name})")
            return
        if isinstance(value, list) and value and isinstance(value[0], str):
            arr = (ctypes.c_char_p * len(value))(*[s.encode()
                                                   for s in value])
            self._ok(self.lib.nc_put_att_string(
                self.ncid, vid, key, ctypes.c_size_t(len(value)), arr),
                f"put_att({name})")
            return
        if isinstance(value, bool) or isinstance(value, int):
            value = np.int32(value)
        elif isinstance(value, float):
            value = np.float64(value)
        a = np.ascontiguousarray(np.atleast_1d(value))
        self._ok(self.lib.nc_put_att(self.ncid, vid, key, _NCTYPE[a.dtype],
                                     ctypes.c_size_t(a.size),
                                     a.ctypes.data_as(ctypes.c_void_p)),
                 f"put_att({name})")

    def put(self, name, data, start=None):
        """nc_put_vara of ``data`` at ``start`` (0 by default); the
        variable's type, in native byte order."""
        a = np.ascontiguousarray(data)
        if a.dtype.kind != "S":
            a = a.astype(a.dtype.newbyteorder("="))
        start = start or (0,) * a.ndim
        st = (ctypes.c_size_t * max(a.ndim, 1))(*start)
        ct = (ctypes.c_size_t * max(a.ndim, 1))(*a.shape)
        self._ok(self.lib.nc_put_vara(self.ncid, self.vars[name], st, ct,
                                      a.ctypes.data_as(ctypes.c_void_p)),
                 f"nc_put_vara({name})")

    def enddef(self):
        self._ok(self.lib.nc_enddef(self.ncid), "nc_enddef")

    def close(self):
        if self.ncid is not None:
            self._ok(self.lib.nc_close(self.ncid), "nc_close")
            self.ncid = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---- MPAS's layout -------------------------------------------------------

#: MPAS writes its namelist and streams as global attributes; more than 8
#: global attributes make HDF5 store them dense (fractal heap, v2 B-trees)
MPAS_CONFIG_ATTRS = {f"config_extra_{i:03d}": (i * 0.5 if i % 3 else
                                               f"value {i}")
                     for i in range(40)}
_STRLEN = 64


def _mpas_dims(f, mesh):
    f.def_dim("Time", None)
    f.def_dim("nCells", mesh.ncells)
    f.def_dim("nVertices", mesh.nvertices)
    f.def_dim("nVertLevels", mesh.nz)
    f.def_dim("nVertLevelsP1", mesh.nzp1)
    f.def_dim("nSoilLevels", max(mesh.nsoil, 1))
    f.def_dim("StrLen", _STRLEN)


def _mpas_globals(f, attrs):
    for k, v in {**attrs, **MPAS_CONFIG_ATTRS}.items():
        f.put_att(k, v)


def write_mpas_grid(mesh, path, n_attrs=None):
    """An MPAS static/init file through netCDF-C: the variables
    ``mesh/mpas.read_mesh`` reads, deflated, ``Time`` unlimited."""
    with NCWriter(path) as f:
        _mpas_dims(f, mesh)
        f.def_dim("maxEdges", mesh.max_edges)
        f.def_dim("vertexDegree", 3)
        zs = mesh.zs if mesh.zs is not None else np.array([0.05])
        data = {
            "latCell": (("nCells",), np.deg2rad(mesh.lat_cell)),
            "lonCell": (("nCells",), np.deg2rad(np.mod(mesh.lon_cell, 360))),
            "latVertex": (("nVertices",), np.deg2rad(mesh.lat_vertex)),
            "lonVertex": (("nVertices",),
                          np.deg2rad(np.mod(mesh.lon_vertex, 360))),
            "verticesOnCell": (("nCells", "maxEdges"),
                               (mesh.vertices_on_cell + 1).astype(np.int32)),
            "cellsOnVertex": (("nVertices", "vertexDegree"),
                              (mesh.cells_on_vertex + 1).astype(np.int32)),
            "zs": (("nCells", "nSoilLevels"),
                   np.broadcast_to(zs, (mesh.ncells, len(zs)))),
            "ter": (("nCells",), mesh.ter),
        }
        for name, (dims, a) in data.items():
            f.def_var(name, a.dtype, dims, deflate=1, shuffle=True)
        _mpas_globals(f, {"on_a_sphere": "YES", "sphere_radius": 6371229.0})
        f.enddef()
        for name, (_, a) in data.items():
            f.put(name, a)


def write_mpas_data(mesh, path, fields, attrs, xtime, dtype="f4"):
    """An MPAS diag or history file through netCDF-C: each field
    ``(Time, nCells|nVertices[, levels])`` chunked with deflate level 1
    and shuffle, ``xtime`` ``char(Time, StrLen)``, the global attributes
    dense."""
    lev = {mesh.nz: "nVertLevels", mesh.nzp1: "nVertLevelsP1"}
    if mesh.nsoil and mesh.nsoil not in lev:
        lev[mesh.nsoil] = "nSoilLevels"
    with NCWriter(path) as f:
        _mpas_dims(f, mesh)
        f.def_var("xtime", "S1", ("Time", "StrLen"))
        arrays = {}
        for name, a in fields.items():
            a = np.asarray(a, dtype)
            loc = "nCells" if a.shape[0] == mesh.ncells else "nVertices"
            dims = ("Time", loc) + ((lev[a.shape[1]],) if a.ndim == 2
                                    else ())
            f.def_var(name, dtype, dims, deflate=1, shuffle=True)
            f.put_att("units", "si", var=name)
            f.put_att("long_name", name + " field", var=name)
            arrays[name] = a
        _mpas_globals(f, attrs)
        f.enddef()
        xt = np.frombuffer((xtime + " " * _STRLEN)[:_STRLEN].encode(),
                           "S1").reshape(1, _STRLEN)
        f.put("xtime", xt)
        for name, a in arrays.items():
            f.put(name, a[None])


def write_mpas_case(mesh, d, hist, diag):
    """grid.nc, diag.nc and hist.nc of tests/test_pipeline.make_case's
    fields through netCDF-C, under directory ``d``; returns their paths."""
    attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 60.0,
             "config_lsm_scheme": "noah",
             "config_microp_scheme": "mp_thompson",
             "config_convection_scheme": "cu_ntiedke"}
    paths = {k: os.path.join(str(d), f"{k}_ncc.nc")
             for k in ("grid", "diag", "hist")}
    write_mpas_grid(mesh, paths["grid"])
    write_mpas_data(mesh, paths["diag"], diag,
                    {**attrs, "output_interval": 15}, "2024-03-25_10:00:00")
    write_mpas_data(mesh, paths["hist"], hist, attrs, "2024-03-25_10:00:00")
    return paths


# ---- WRF's layout --------------------------------------------------------

def write_wrf_target(path, grid, cfg, deflate=1, hgt=None, map_proj=None,
                     drop=()):
    """A wrfout-style target file through netCDF-C from a ``TargetGrid``
    and its ``Config``: XLAT/XLONG (and _U/_V), MAPFAC_M/U/V/MX/MY/UX/UY/
    VX/VY, SINALPHA, COSALPHA, HGT as (Time, south_north, west_east)
    floats, deflated and chunked, with WRF's map attributes and more
    than 8 of them (stored dense). ``map_proj`` overrides MAP_PROJ;
    ``drop`` leaves variables out."""
    ny, nx = grid.ny, grid.nx
    f32 = np.float32
    v = {
        "XLAT": (grid.lat, ""), "XLONG": (grid.lon, ""),
        "XLAT_U": (grid.lat_u, "X"), "XLONG_U": (grid.lon_u, "X"),
        "XLAT_V": (grid.lat_v, "Y"), "XLONG_V": (grid.lon_v, "Y"),
        "MAPFAC_M": (grid.mapfac_m, ""), "MAPFAC_U": (grid.mapfac_u, "X"),
        "MAPFAC_V": (grid.mapfac_v, "Y"), "MAPFAC_MX": (grid.mapfac_m, ""),
        "MAPFAC_MY": (grid.mapfac_m, ""), "MAPFAC_UX": (grid.mapfac_u, "X"),
        "MAPFAC_UY": (grid.mapfac_u, "X"), "MAPFAC_VX": (grid.mapfac_v, "Y"),
        "MAPFAC_VY": (grid.mapfac_v, "Y"),
        "SINALPHA": (grid.sina, ""), "COSALPHA": (grid.cosa, ""),
        "HGT": (np.zeros((ny, nx)) if hgt is None else hgt, ""),
    }
    dims = {"": ("Time", "south_north", "west_east"),
            "X": ("Time", "south_north", "west_east_stag"),
            "Y": ("Time", "south_north_stag", "west_east")}
    with NCWriter(path) as f:
        f.def_dim("Time", None)
        f.def_dim("DateStrLen", 19)
        f.def_dim("west_east", nx)
        f.def_dim("south_north", ny)
        f.def_dim("west_east_stag", nx + 1)
        f.def_dim("south_north_stag", ny + 1)
        f.def_var("Times", "S1", ("Time", "DateStrLen"))
        for name, (a, stag) in v.items():
            if name in drop:
                continue
            f.def_var(name, "f4", dims[stag], deflate=deflate, shuffle=True)
            f.put_att("FieldType", 104, var=name)
            f.put_att("MemoryOrder", "XY ", var=name)
            f.put_att("units", "degree_north" if "LAT" in name else "",
                      var=name)
            f.put_att("stagger", stag, var=name)
        gatts = {
            "TITLE": " OUTPUT FROM WRF V4.5 MODEL",
            "WEST-EAST_GRID_DIMENSION": nx + 1,
            "SOUTH-NORTH_GRID_DIMENSION": ny + 1,
            "DX": f32(cfg.dx), "DY": f32(cfg.dy),
            "CEN_LAT": f32(cfg.ref_lat), "CEN_LON": f32(cfg.ref_lon),
            "TRUELAT1": f32(cfg.truelat1),
            "TRUELAT2": f32(cfg.truelat2 if cfg.truelat2 is not None
                            else cfg.truelat1),
            "MOAD_CEN_LAT": f32(cfg.ref_lat), "STAND_LON": f32(cfg.stand_lon),
            "POLE_LAT": f32(90.0), "POLE_LON": f32(0.0),
            "MAP_PROJ": cfg.proj_code if map_proj is None else map_proj,
            "MAP_PROJ_CHAR": cfg.map_proj_char,
        }
        for k, val in gatts.items():
            f.put_att(k, val)
        f.enddef()
        f.put("Times", np.frombuffer(b"2024-03-25_10:00:00", "S1")
              .reshape(1, 19))
        for name, (a, _) in v.items():
            if name not in drop:
                f.put(name, np.asarray(a, f32)[None])


# ---- a copy through netCDF-C ------------------------------------------------

_HIDDEN = ("CLASS", "NAME", "DIMENSION_LIST", "REFERENCE_LIST")


def _att_value(v):
    """An attribute as h5py read it, for ``NCWriter.put_att``."""
    if type(v).__name__ == "Empty" or isinstance(v, (bytes, np.bytes_)):
        return "" if type(v).__name__ == "Empty" else bytes(v).decode()
    if isinstance(v, str):
        return v
    return np.asarray(v)


def copy_through_netcdf_c(src, dst, deflate=1):
    """Rewrite a NetCDF4 file through netCDF-C, as the Fortran MPASSIT
    writes its output (``nf90_create(NF90_NETCDF4)``, every variable
    deflated and shuffled): the same dims in order (``Time`` unlimited),
    global and variable attributes with their types, variables and
    values. ``src`` is read through h5py."""
    import h5py

    with h5py.File(src, "r") as f, NCWriter(dst) as g:
        dims = sorted((int(ds.attrs["_Netcdf4Dimid"]), name, ds.shape[0],
                       ds.maxshape[0] is None)
                      for name, ds in f.items() if "_Netcdf4Dimid" in
                      ds.attrs)
        for _, name, size, unlimited in dims:
            g.def_dim(name, None if unlimited else size)
        for k, v in f.attrs.items():
            if not k.startswith("_NC"):
                g.put_att(k, _att_value(v))
        data = {}
        for name, ds in f.items():
            if "_Netcdf4Dimid" in ds.attrs:
                continue
            names = [d[0].name.lstrip("/") for d in ds.dims]
            g.def_var(name, ds.dtype, names, deflate=deflate, shuffle=True)
            for k, v in ds.attrs.items():
                if k not in _HIDDEN and not k.startswith("_Netcdf4"):
                    g.put_att(k, _att_value(v), var=name)
            data[name] = ds[...]
        g.enddef()
        for name, a in data.items():
            g.put(name, a)


# ---- h5py with libver "latest" --------------------------------------------

_NC_DIM_NAME = "This is a netCDF dimension but not a netCDF variable. %10d"


class H5Writer:
    """A NetCDF4 file written through h5py with netCDF-C's conventions
    (dimension scales named as netCDF-C names them, ``_Netcdf4Dimid``,
    ``_Netcdf4Coordinates``, ``DIMENSION_LIST``; creation order tracked),
    under the library-version bound ``libver`` ("latest": HDF5 1.10's
    chunk indexes, an extensible array for a variable with one unlimited
    dimension and a fixed array for one with none, as netCDF-C linked
    against HDF5 1.10.0/1.10.1 or h5netcdf so configured write them)."""

    def __init__(self, path, libver="latest"):
        import h5py

        self.h5py = h5py
        self.f = h5py.File(path, "w", libver=libver, track_order=True)
        self.dims = {}

    def def_dim(self, name, size, data=None, records=0):
        """``size`` None: unlimited, at ``records`` (netCDF-C leaves it at
        0); ``data``: a coordinate variable's values."""
        if size is None:
            ds = self.f.create_dataset(name, shape=(records,),
                                       maxshape=(None,), dtype="f4",
                                       chunks=(1024,), track_order=True)
        elif data is None:
            ds = self.f.create_dataset(name, shape=(size,), dtype="f4",
                                       track_order=True)
        else:
            ds = self.f.create_dataset(name, data=data, track_order=True)
        ds.make_scale(name if data is not None
                      else _NC_DIM_NAME % (size or 0))
        ds.attrs["_Netcdf4Dimid"] = np.int32(len(self.dims))
        self.dims[name] = ds

    def def_var(self, name, dims, data, **h5kw):
        """A variable with its data: chunked along ``h5kw`` (h5py's
        create_dataset keywords: chunks, compression, scaleoffset, ...),
        unlimited where its dimension is."""
        maxshape = tuple(None if self.dims[d].maxshape[0] is None else n
                         for d, n in zip(dims, np.shape(data)))
        ds = self.f.create_dataset(name, data=data, maxshape=maxshape,
                                   track_order=True, **h5kw)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self.dims[d])
        ds.attrs["_Netcdf4Coordinates"] = np.array(
            [list(self.dims).index(d) for d in dims], np.int32)
        return ds

    def put_att(self, name, value, var=None):
        """str: fixed-length text as netCDF-C's NC_CHAR ("" a null
        dataspace); numbers as they are."""
        target = self.f if var is None else self.f[var]
        if isinstance(value, str):
            value = (self.h5py.Empty(np.dtype("S1")) if not value
                     else np.bytes_(value.encode()))
        target.attrs[name] = value

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


_NC_HIDDEN = ("CLASS", "NAME", "DIMENSION_LIST", "REFERENCE_LIST",
              "_Netcdf4Dimid", "_Netcdf4Coordinates")


def copy_through_h5py(src, dst, filters):
    """Rewrite a NetCDF4 file through h5py with libver "latest" (see
    ``H5Writer``): the same dims in order, variables with their data and
    attributes, global attributes. ``filters(name, array, unlimited)``
    gives each variable's create_dataset keywords (chunks and filters);
    ``unlimited`` says which axes are."""
    import h5py

    with h5py.File(src, "r") as f, H5Writer(dst) as g:
        dims = sorted((int(ds.attrs["_Netcdf4Dimid"]), name, ds)
                      for name, ds in f.items()
                      if "_Netcdf4Dimid" in ds.attrs)
        for _, name, ds in dims:
            unlimited = ds.maxshape[0] is None
            g.def_dim(name, None if unlimited else ds.shape[0],
                      records=ds.shape[0] if unlimited else 0)
        for k, v in f.attrs.items():
            g.f.attrs[k] = v
        for name, ds in f.items():
            if "_Netcdf4Dimid" in ds.attrs:
                continue
            a = ds[...]
            names = [d[0].name.lstrip("/") for d in ds.dims]
            g.def_var(name, names, a, **filters(
                name, a, [g.dims[d].maxshape[0] is None for d in names]))
            for k, v in ds.attrs.items():
                if k not in _NC_HIDDEN:
                    g.f[name].attrs[k] = v


def mixed_filters(name, a, unlimited):
    """szip (NN, 8 pixels per block) and LZF in turn by the variable's
    name; a chunk is one record of an unlimited axis and at most 500
    elements along the first other axis (several chunks per record);
    text through LZF."""
    fixed = [i for i, u in enumerate(unlimited) if not u]
    chunks = tuple(1 if u else min(n, 500) if i == fixed[0] else n
                   for i, (n, u) in enumerate(zip(a.shape, unlimited)))
    if a.dtype.kind == "S" or sum(map(ord, name)) % 2:
        return dict(chunks=chunks, compression="lzf", shuffle=True)
    return dict(chunks=chunks, compression="szip",
                compression_opts=("nn", 8))


def write_wrf_target_latest(path, grid, cfg):
    """A WRF target file as h5py writes it with libver "latest" (see
    ``H5Writer``): XLAT/XLONG, MAPFAC_M, SINALPHA, COSALPHA and HGT as
    (Time, south_north, west_east) under extensible-array indexes, the
    staggered XLAT/XLONG_U/V and MAPFAC_U/V as 2-D fields under fixed
    arrays; szip (NN and EC) and LZF in turn, LU_INDEX an integer under
    scale-offset, and a 1,000-value global attribute (``ETA_LEVELS``, a
    huge object of the dense attribute storage's heap)."""
    ny, nx = grid.ny, grid.nx
    f32 = np.float32
    nn, ec = (dict(compression="szip", compression_opts=(m, 8))
              for m in ("nn", "ec"))
    lzf = dict(compression="lzf", shuffle=True)
    hgt = (1500.0 * np.exp(-((grid.lon + 110.0) / 8.0) ** 2)
           * (1 + 0.2 * np.sin(np.deg2rad(grid.lat) * 5)))
    lu = 1 + (np.abs(np.round(grid.lat * 3 + grid.lon)) % 21)
    rec = {"XLAT": (grid.lat, nn), "XLONG": (grid.lon, nn),
           "MAPFAC_M": (grid.mapfac_m, lzf), "SINALPHA": (grid.sina, ec),
           "COSALPHA": (grid.cosa, lzf), "HGT": (hgt, nn),
           "LU_INDEX": (lu.astype(np.int32), dict(scaleoffset=0))}
    flat = {"XLAT_U": (grid.lat_u, "X", lzf), "XLONG_U": (grid.lon_u, "X", ec),
            "XLAT_V": (grid.lat_v, "Y", nn), "XLONG_V": (grid.lon_v, "Y", lzf),
            "MAPFAC_U": (grid.mapfac_u, "X", nn),
            "MAPFAC_V": (grid.mapfac_v, "Y", ec)}
    dims2 = {"X": ("south_north", "west_east_stag"),
             "Y": ("south_north_stag", "west_east")}
    with H5Writer(path) as f:
        f.def_dim("Time", None)
        f.def_dim("DateStrLen", 19)
        f.def_dim("west_east", nx)
        f.def_dim("south_north", ny)
        f.def_dim("west_east_stag", nx + 1)
        f.def_dim("south_north_stag", ny + 1)
        f.def_var("Times", ("Time", "DateStrLen"),
                  np.frombuffer(b"2024-03-25_10:00:00", "S1").reshape(1, 19),
                  chunks=(1, 19), **lzf)
        for name, (a, kw) in rec.items():
            a = np.asarray(a, np.int32 if name == "LU_INDEX" else f32)[None]
            f.def_var(name, ("Time", "south_north", "west_east"), a,
                      chunks=(1, -(-ny // 2), -(-nx // 2)), **kw)
            f.put_att("FieldType", 106 if name == "LU_INDEX" else 104,
                      var=name)
            f.put_att("MemoryOrder", "XY ", var=name)
            f.put_att("stagger", "", var=name)
        for name, (a, stag, kw) in flat.items():
            a = np.asarray(a, f32)
            f.def_var(name, dims2[stag], a,
                      chunks=tuple(-(-n // 2) for n in a.shape), **kw)
            f.put_att("FieldType", 104, var=name)
            f.put_att("stagger", stag, var=name)
        gatts = {
            "TITLE": " OUTPUT FROM WRF V4.5 MODEL",
            "WEST-EAST_GRID_DIMENSION": np.int32(nx + 1),
            "SOUTH-NORTH_GRID_DIMENSION": np.int32(ny + 1),
            "DX": f32(cfg.dx), "DY": f32(cfg.dy),
            "CEN_LAT": f32(cfg.ref_lat), "CEN_LON": f32(cfg.ref_lon),
            "TRUELAT1": f32(cfg.truelat1), "TRUELAT2": f32(cfg.truelat2),
            "MOAD_CEN_LAT": f32(cfg.ref_lat), "STAND_LON": f32(cfg.stand_lon),
            "POLE_LAT": f32(90.0), "POLE_LON": f32(0.0),
            "MAP_PROJ": np.int32(cfg.proj_code),
            "MAP_PROJ_CHAR": cfg.map_proj_char,
            "ETA_LEVELS": np.linspace(1.0, 0.0, 1000),
        }
        for k, val in gatts.items():
            f.put_att(k, val)


# ---- the manifest ----------------------------------------------------------

def make_target_fixture(path):
    """A 150x100 Lambert conformal grid at 36 km over CONUS."""
    from mpassit_tpu_torch.config import Config
    from mpassit_tpu_torch.grids.target import build_target_grid

    cfg = Config.from_dict({"target_grid_type": "lambert", "nx": 151,
                            "ny": 101, "dx": 36000.0, "dy": 36000.0,
                            "ref_lat": 38.5, "ref_lon": -97.5,
                            "truelat1": 38.5, "truelat2": 38.5,
                            "stand_lon": -97.5})
    grid = build_target_grid(cfg)
    hgt = (1500.0 * np.exp(-((grid.lon + 110.0) / 8.0) ** 2)
           * (1 + 0.2 * np.sin(np.deg2rad(grid.lat) * 5)))
    write_wrf_target(path, grid, cfg, hgt=hgt)


def make_latest_target_fixture(path):
    """A 60x45 Lambert conformal grid at 30 km over the central US,
    written by h5py with libver "latest" (``write_wrf_target_latest``)."""
    from mpassit_tpu_torch.config import Config
    from mpassit_tpu_torch.grids.target import build_target_grid

    cfg = Config.from_dict({"target_grid_type": "lambert", "nx": 61,
                            "ny": 46, "dx": 30000.0, "dy": 30000.0,
                            "ref_lat": 38.5, "ref_lon": -97.5,
                            "truelat1": 38.5, "truelat2": 38.5,
                            "stand_lon": -97.5})
    write_wrf_target_latest(path, build_target_grid(cfg), cfg)


def make_diag_fixture(path):
    """A small MPAS-layout diag file: fields chunked under a v1 B-tree
    with deflate and shuffle, one big-endian, one with fletcher32, an
    NC_STRING attribute, the global attributes dense."""
    n, nz = 500, 6
    rng = np.random.default_rng(11)
    with NCWriter(path) as f:
        f.def_dim("Time", None)
        f.def_dim("nCells", n)
        f.def_dim("nVertLevels", nz)
        f.def_dim("StrLen", _STRLEN)
        f.def_var("xtime", "S1", ("Time", "StrLen"))
        f.def_var("t2m", "f4", ("Time", "nCells"), deflate=1, shuffle=True)
        f.def_var("refl10cm", "f4", ("Time", "nCells", "nVertLevels"),
                  deflate=1, shuffle=True, chunks=(1, 128, nz))
        f.def_var("u10", "f8", ("Time", "nCells"), big_endian=True,
                  deflate=4)
        f.def_var("mslp", "f4", ("Time", "nCells"), fletcher32=True)
        f.def_var("kindex", "i2", ("Time", "nCells"), deflate=1,
                  shuffle=True, fill=np.int16(-999))
        f.put_att("units", "K", var="t2m")
        f.put_att("valid_range", np.array([150.0, 350.0], np.float32),
                  var="t2m")
        f.put_att("history", ["written by netCDF-C", "for the port"])
        _mpas_globals(f, {"config_start_time": "2024-03-25_09:00:00",
                          "output_interval": 60})
        f.enddef()
        f.put("xtime", np.frombuffer(
            (("2024-03-25_10:00:00" + " " * _STRLEN)[:_STRLEN]).encode(),
            "S1").reshape(1, _STRLEN))
        f.put("t2m", (280 + rng.standard_normal((1, n))).astype("f4"))
        f.put("refl10cm", rng.standard_normal((1, n, nz)).astype("f4"))
        f.put("u10", rng.standard_normal((1, n)))
        f.put("mslp", (1e5 + 100 * rng.standard_normal((1, n)))
              .astype("f4"))
        # kindex: only its first 300 cells written; the rest is fill
        f.put("kindex", rng.integers(-50, 50, (1, 300)).astype("i2"))


def main():
    import h5py

    os.makedirs(FIXTURES, exist_ok=True)
    files = {"wrf_lambert_target.nc": make_target_fixture,
             "mpas_diag_tiny.nc": make_diag_fixture,
             "wrf_lambert_latest.nc": make_latest_target_fixture}
    manifest = {"writer": libnetcdf().nc_inq_libvers().decode().split()[0],
                "writer_latest": f"h5py {h5py.version.version}, HDF5 "
                                 f"{h5py.version.hdf5_version}",
                "files": {}}
    for name, make in files.items():
        path = os.path.join(FIXTURES, name)
        make(path)
        with h5py.File(path, "r") as f:
            manifest["files"][name] = describe_hdf5(f)
    with open(os.path.join(FIXTURES, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=False)
        fh.write("\n")
    total = sum(os.path.getsize(os.path.join(FIXTURES, n))
                for n in os.listdir(FIXTURES))
    print(f"{FIXTURES}: {total} bytes")


if __name__ == "__main__":
    main()
