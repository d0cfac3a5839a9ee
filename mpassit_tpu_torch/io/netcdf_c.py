"""ctypes binding to the system netCDF-C library (``libnetcdf.so``).

The reference links against netcdf-fortran/netCDF-C and its output is
consumed by UPP through the same library (``write_data.F90:173`` creates a
true ``NF90_NETCDF4`` file). Our writer (``io/nc4.py``) hand-rolls the
netCDF4-on-HDF5 conventions through h5py; this module is the
interoperability oracle: it reads files through the *actual* netCDF-C
implementation, so tests can assert that every file we produce is readable
by the library UPP links against (``nc_open``/``nc_inq*``/``nc_get_var*``).

It deliberately exposes the same reader API as ``nc4.NetCDF4File`` so it can
also serve as a drop-in reader backend where libnetcdf is present.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

# netCDF external data types (netcdf.h)
NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
NC_UBYTE, NC_USHORT, NC_UINT, NC_INT64, NC_UINT64, NC_STRING = 7, 8, 9, 10, 11, 12

_NP_BY_NCTYPE = {
    NC_BYTE: np.int8, NC_CHAR: "S1", NC_SHORT: np.int16, NC_INT: np.int32,
    NC_FLOAT: np.float32, NC_DOUBLE: np.float64, NC_UBYTE: np.uint8,
    NC_USHORT: np.uint16, NC_UINT: np.uint32, NC_INT64: np.int64,
    NC_UINT64: np.uint64,
}

NC_NOWRITE = 0
NC_GLOBAL = -1
NC_MAX_NAME = 256

_lib = None


def load_libnetcdf():
    """Locate and load libnetcdf; returns None when unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libnetcdf.so", "libnetcdf.so.19", "libnetcdf.so.18",
                 "libnetcdf.so.15", ctypes.util.find_library("netcdf")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.nc_strerror.restype = ctypes.c_char_p
        _lib = lib
        return lib
    return None


def available() -> bool:
    return load_libnetcdf() is not None


class NetCDFCError(OSError):
    pass


def _check(rc: int, what: str):
    if rc != 0:
        msg = load_libnetcdf().nc_strerror(rc).decode()
        raise NetCDFCError(f"{what}: {msg} (rc={rc})")


class NetCDFCFile:
    """Read-only netCDF file opened through the system netCDF-C library."""

    def __init__(self, path: str):
        self._lib = load_libnetcdf()
        if self._lib is None:
            raise NetCDFCError("libnetcdf not found on this system")
        ncid = ctypes.c_int()
        _check(self._lib.nc_open(path.encode(), NC_NOWRITE,
                                 ctypes.byref(ncid)), f"nc_open({path})")
        self.ncid = ncid.value
        self.path = path
        self._dims: dict[str, int] = {}       # name -> dimid
        self._vars: dict[str, int] = {}       # name -> varid
        self._load_inventory()

    # -- inventory -----------------------------------------------------------

    def _load_inventory(self):
        ndims, nvars, natts, unlim = (ctypes.c_int() for _ in range(4))
        _check(self._lib.nc_inq(self.ncid, ctypes.byref(ndims),
                                ctypes.byref(nvars), ctypes.byref(natts),
                                ctypes.byref(unlim)), "nc_inq")
        self.n_global_attrs = natts.value
        self.unlimited_dimid = unlim.value
        buf = ctypes.create_string_buffer(NC_MAX_NAME + 1)
        for dimid in range(ndims.value):
            _check(self._lib.nc_inq_dimname(self.ncid, dimid, buf),
                   "nc_inq_dimname")
            self._dims[buf.value.decode()] = dimid
        for varid in range(nvars.value):
            _check(self._lib.nc_inq_varname(self.ncid, varid, buf),
                   "nc_inq_varname")
            self._vars[buf.value.decode()] = varid

    def close(self):
        if self.ncid is not None:
            self._lib.nc_close(self.ncid)
            self.ncid = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- reader API (mirrors nc4.NetCDF4File) --------------------------------

    def has_dim(self, name: str) -> bool:
        return name in self._dims

    def dim_size(self, name: str) -> int:
        ln = ctypes.c_size_t()
        _check(self._lib.nc_inq_dimlen(self.ncid, self._dims[name],
                                       ctypes.byref(ln)), "nc_inq_dimlen")
        return ln.value

    def dim_names(self):
        return list(self._dims)

    def unlimited_dim(self) -> str | None:
        for name, dimid in self._dims.items():
            if dimid == self.unlimited_dimid:
                return name
        return None

    def has_var(self, name: str) -> bool:
        return name in self._vars

    def var_names(self):
        return list(self._vars)

    def var_dims(self, name: str):
        varid = self._vars[name]
        nd = ctypes.c_int()
        _check(self._lib.nc_inq_varndims(self.ncid, varid, ctypes.byref(nd)),
               "nc_inq_varndims")
        dimids = (ctypes.c_int * max(nd.value, 1))()
        _check(self._lib.nc_inq_vardimid(self.ncid, varid, dimids),
               "nc_inq_vardimid")
        by_id = {v: k for k, v in self._dims.items()}
        return [by_id[dimids[i]] for i in range(nd.value)]

    def var_dtype(self, name: str):
        xtype = ctypes.c_int()
        _check(self._lib.nc_inq_vartype(self.ncid, self._vars[name],
                                        ctypes.byref(xtype)), "nc_inq_vartype")
        return np.dtype(_NP_BY_NCTYPE[xtype.value])

    def read_var(self, name: str):
        varid = self._vars[name]
        shape = tuple(self.dim_size(d) for d in self.var_dims(name))
        dtype = self.var_dtype(name)
        out = np.empty(shape, dtype)
        getters = {
            np.dtype(np.float32): self._lib.nc_get_var_float,
            np.dtype(np.float64): self._lib.nc_get_var_double,
            np.dtype(np.int32): self._lib.nc_get_var_int,
            np.dtype(np.int64): self._lib.nc_get_var_longlong,
            np.dtype(np.int16): self._lib.nc_get_var_short,
            np.dtype(np.int8): self._lib.nc_get_var_schar,
        }
        if dtype == np.dtype("S1"):
            getter = self._lib.nc_get_var_text
        else:
            getter = getters[dtype]
        _check(getter(self.ncid, varid,
                      out.ctypes.data_as(ctypes.c_void_p)),
               f"nc_get_var({name})")
        return out

    # -- attributes -----------------------------------------------------------

    def _att(self, varid: int, name: str):
        xtype, ln = ctypes.c_int(), ctypes.c_size_t()
        rc = self._lib.nc_inq_att(self.ncid, varid, name.encode(),
                                  ctypes.byref(xtype), ctypes.byref(ln))
        if rc != 0:
            raise KeyError(name)
        if xtype.value == NC_CHAR:
            buf = ctypes.create_string_buffer(ln.value + 1)
            _check(self._lib.nc_get_att_text(self.ncid, varid, name.encode(),
                                             buf), f"nc_get_att_text({name})")
            return buf.raw[:ln.value].decode("utf-8", "replace")
        if xtype.value == NC_STRING:
            arr = (ctypes.c_char_p * ln.value)()
            _check(self._lib.nc_get_att_string(self.ncid, varid,
                                               name.encode(), arr),
                   f"nc_get_att_string({name})")
            vals = [(s or b"").decode("utf-8", "replace") for s in arr]
            self._lib.nc_free_string(ln.value, arr)
            return vals[0] if len(vals) == 1 else vals
        np_t = _NP_BY_NCTYPE[xtype.value]
        out = np.empty(ln.value, np_t)
        getters = {
            NC_FLOAT: self._lib.nc_get_att_float,
            NC_DOUBLE: self._lib.nc_get_att_double,
            NC_INT: self._lib.nc_get_att_int,
            NC_INT64: self._lib.nc_get_att_longlong,
            NC_SHORT: self._lib.nc_get_att_short,
            NC_BYTE: self._lib.nc_get_att_schar,
        }
        _check(getters[xtype.value](self.ncid, varid, name.encode(),
                                    out.ctypes.data_as(ctypes.c_void_p)),
               f"nc_get_att({name})")
        if out.size == 1:
            return out[0].item()
        return out

    def _att_names(self, varid: int, natts: int):
        buf = ctypes.create_string_buffer(NC_MAX_NAME + 1)
        names = []
        for i in range(natts):
            _check(self._lib.nc_inq_attname(self.ncid, varid, i, buf),
                   "nc_inq_attname")
            names.append(buf.value.decode())
        return names

    def get_attr(self, name: str, default=KeyError):
        try:
            return self._att(NC_GLOBAL, name)
        except KeyError:
            if default is KeyError:
                raise
            return default

    def global_attr_names(self):
        return self._att_names(NC_GLOBAL, self.n_global_attrs)

    def var_attrs(self, name: str):
        varid = self._vars[name]
        natts = ctypes.c_int()
        _check(self._lib.nc_inq_varnatts(self.ncid, varid,
                                         ctypes.byref(natts)),
               "nc_inq_varnatts")
        return {n: self._att(varid, n)
                for n in self._att_names(varid, natts.value)
                if not n.startswith("_")}
