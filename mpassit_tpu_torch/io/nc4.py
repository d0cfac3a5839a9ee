"""Minimal NetCDF reader/writer (no netCDF4/xarray in this environment).

Replaces the functionality the reference consumes from netcdf-fortran/NetCDF-C
(SURVEY §2.3): ``nf90_open/inq/get_var/get_att`` for input and
``nf90_create(NF90_NETCDF4)/def_dim/def_var/put_att/put_var`` for output
(write_data.F90:173-997).

- NetCDF4 files are HDF5 with the standard netCDF4-on-HDF5 conventions
  (dimension scales, ``_Netcdf4Dimid``, ``DIMENSION_LIST``) so files
  interoperate with the netCDF-C library. They are always written by the
  port's own encoder (``io/hdf5.py``, numpy only), and read through h5py
  where it is importable, else through ``io/hdf5.py``'s reader.
- Classic-format files (CDF-1/2, common for MPAS history streams, and
  CDF-5, the 64-bit-data variant production MPAS runs write for >4 GiB
  variables) are read by the pure-Python ``_CDFReader`` below, from an
  mmap: no h5py, and no 2-GiB limit on record data.
"""

from __future__ import annotations

import sys

import numpy as np

from ..errors import FatalError
from . import hdf5

#: classic-format magic -> version byte (CDF-1 32-bit offsets, CDF-2 64-bit
#: offsets, CDF-5 64-bit data)
_CDF_VERSIONS = {b"CDF\x01": 1, b"CDF\x02": 2, b"CDF\x05": 5}


def _decode(v):
    # a null dataspace (a zero-length text attribute): hdf5.Empty, or
    # h5py.Empty, which can only come from a file h5py opened, so h5py is
    # never imported here
    h5py = sys.modules.get("h5py")
    if isinstance(v, hdf5.Empty) or (h5py is not None
                                     and isinstance(v, h5py.Empty)):
        return ""
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        if v.ndim == 0:
            return _decode(v[()])
        if v.size == 1:
            return _decode(v.reshape(-1)[0])
        return v
    if isinstance(v, np.generic):
        return v.item() if not isinstance(v, np.bytes_) else v.item().decode()
    return v


# ---- classic-format (CDF-1, CDF-2, CDF-5) reader ---------------------------
# Spec: Unidata's "NetCDF Classic and 64-bit Offset Format" and the pnetcdf
# "CDF-5 file format specification". The three differ only in field widths:
# CDF-1 and CDF-2 write every count, length, dimid and vsize (NON_NEG) as
# int32 and `begin` as int32 (CDF-1) or int64 (CDF-2); CDF-5 widens all of
# them to int64 and adds the unsigned/64-bit external types 7-11. Checked
# against scipy's reader of CDF-1/2 and against the JAX package's CDF-5
# reader, itself checked against libnetcdf (tests/test_torch_nc4_classic.py,
# tests/test_nc4_cdf5.py).

_NC_TYPES = {
    1: ("b", 1), 2: ("S1", 1), 3: (">i2", 2), 4: (">i4", 4),
    5: (">f4", 4), 6: (">f8", 8), 7: ("u1", 1), 8: (">u2", 2),
    9: (">u4", 4), 10: (">i8", 8), 11: (">u8", 8),
}


class _CDFReader:
    """Read-only pure-Python parser of CDF-1, CDF-2 and CDF-5 files (same
    protocol as the other readers). The header is parsed eagerly; variable
    data is read lazily from a read-only mmap of the file at each
    ``read_var`` (record variables gathered across their per-record
    slots), so record data past 2 GiB and variables past 4 GiB read like
    any other. For CDF-1/2 it returns what scipy.io.netcdf_file did: the
    same big-endian arrays, text attributes with trailing NULs stripped,
    one-element numeric attributes as Python scalars."""

    def __init__(self, path: str):
        import mmap

        self._fh = open(path, "rb")
        buf = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self.version = _CDF_VERSIONS.get(bytes(buf[:4]))
        if self.version is None:
            buf.close()
            self._fh.close()
            raise ValueError(f"{path}: not a classic-format NetCDF file")
        self._buf = buf
        self._nw = 8 if self.version == 5 else 4     # NON_NEG width
        self._bw = 4 if self.version == 1 else 8     # `begin` width
        self.numrecs, pos = self._int(4, self._nw)
        self.dims, pos = self._dim_list(pos)       # [(name, length), ...]
        self._gatts, pos = self._att_list(pos)
        self.vars, pos = self._var_list(pos)       # name -> dict
        # record size = sum of record-var slots (vsize: each variable's
        # bytes padded to 4); the single-record-var special case uses the
        # UNPADDED size (spec: no inter-record pad)
        rec_vars = [v for v in self.vars.values() if v["record"]]
        self._recsize = sum(v["vsize"] for v in rec_vars)
        if len(rec_vars) == 1:
            v = rec_vars[0]
            n = int(np.prod([self.dims[d][1] for d in v["dimids"][1:]],
                            dtype=np.int64)) if len(v["dimids"]) > 1 else 1
            self._recsize = n * _NC_TYPES[v["nc_type"]][1]
        if self.numrecs == (1 << (8 * self._nw)) - 1:  # streaming
            if rec_vars and self._recsize:
                first = min(v["begin"] for v in rec_vars)
                self.numrecs = (len(buf) - first) // self._recsize
            else:
                self.numrecs = 0

    # -- primitive parsers --
    def _int(self, pos, width):
        return int.from_bytes(self._buf[pos:pos + width], "big"), pos + width

    def _name(self, pos):
        n, pos = self._int(pos, self._nw)
        s = self._buf[pos:pos + n].decode("utf-8", "replace")
        return s, pos + n + ((-n) % 4)

    def _dim_list(self, pos):
        tag, pos = self._int(pos, 4)
        n, pos = self._int(pos, self._nw)
        dims = []
        for _ in range(n):
            name, pos = self._name(pos)
            ln, pos = self._int(pos, self._nw)
            dims.append((name, ln))
        return dims, pos

    def _att_list(self, pos):
        tag, pos = self._int(pos, 4)
        n, pos = self._int(pos, self._nw)
        atts = {}
        for _ in range(n):
            name, pos = self._name(pos)
            nct, pos = self._int(pos, 4)
            ne, pos = self._int(pos, self._nw)
            dt, sz = _NC_TYPES[nct]
            raw = self._buf[pos:pos + ne * sz]
            pos += ne * sz + ((-(ne * sz)) % 4)
            if nct == 2:
                if self.version != 5:
                    raw = raw.rstrip(b"\x00")
                atts[name] = raw.decode("utf-8", "replace")
            else:
                a = np.frombuffer(raw, dt)
                atts[name] = a.item() if a.size == 1 else a.copy()
        return atts, pos

    def _var_list(self, pos):
        tag, pos = self._int(pos, 4)
        n, pos = self._int(pos, self._nw)
        out = {}
        for _ in range(n):
            name, pos = self._name(pos)
            rank, pos = self._int(pos, self._nw)
            dimids = []
            for _ in range(rank):
                d, pos = self._int(pos, self._nw)
                dimids.append(d)
            atts, pos = self._att_list(pos)
            nct, pos = self._int(pos, 4)
            vsize, pos = self._int(pos, self._nw)
            begin, pos = self._int(pos, self._bw)
            record = bool(dimids) and self.dims[dimids[0]][1] == 0
            if record:
                # a CDF-1/2 vsize saturates at 2^32 - 1 for a variable over
                # 4 GiB: take the slot from the shape
                per = int(np.prod([self.dims[d][1] for d in dimids[1:]],
                                  dtype=np.int64)) * _NC_TYPES[nct][1]
                vsize = per + (-per) % 4
            out[name] = dict(dimids=dimids, atts=atts, nc_type=nct,
                             vsize=vsize, begin=begin, record=record)
        return out, pos

    # -- reader protocol --
    def close(self):
        if hasattr(self._buf, "close"):
            self._buf.close()
        self._buf = b""
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _dim_map(self):
        m = getattr(self, "_dimmap", None)
        if m is None:
            m = {nm: ln for nm, ln in self.dims}
            self._dimmap = m
        return m

    def has_dim(self, name):
        return name in self._dim_map()

    def dim_names(self):
        return [nm for nm, _ in self.dims]

    def dim_size(self, name: str) -> int:
        ln = self._dim_map()[name]
        if ln:
            return ln
        # unlimited: the record count, when a variable uses the dimension
        return self.numrecs if any(v["record"] for v in self.vars.values()) \
            else 0

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def var_names(self):
        return list(self.vars)

    def var_dims(self, name: str):
        return [self.dims[d][0] for d in self.vars[name]["dimids"]]

    def read_var(self, name: str):
        v = self.vars[name]
        dt, sz = _NC_TYPES[v["nc_type"]]
        shape = [self.dims[d][1] for d in v["dimids"]]
        if not v["record"]:
            cnt = int(np.prod(shape, dtype=np.int64)) if shape else 1
            a = np.frombuffer(self._buf, dt, count=cnt, offset=v["begin"])
            # .copy(): hand the caller an OWNED array — a view would pin the
            # mmap and make close() raise BufferError
            return a.reshape(shape).copy()
        shape[0] = self.numrecs
        per = int(np.prod(shape[1:], dtype=np.int64)) if shape[1:] else 1
        if self.numrecs == 0:
            return np.empty(shape, np.dtype(dt))
        # one strided view over the whole record block (each record's slot
        # for this var is rec_bytes wide, slots _recsize apart), then ONE
        # owned copy — O(1) Python work instead of a per-record loop
        rec_bytes = per * sz
        raw = np.frombuffer(
            self._buf, np.uint8,
            count=(self.numrecs - 1) * self._recsize + rec_bytes,
            offset=v["begin"])
        view = np.lib.stride_tricks.as_strided(
            raw, shape=(self.numrecs, rec_bytes),
            strides=(self._recsize, 1))
        return np.ascontiguousarray(view).view(np.dtype(dt)).reshape(shape)

    def var_attrs(self, name: str):
        return dict(self.vars[name]["atts"])

    def get_attr(self, name: str, default=KeyError):
        try:
            return self._gatts[name]
        except KeyError:
            if default is KeyError:
                raise
            return default

    def global_attr_names(self):
        return list(self._gatts)


_NC_DIM_NAME = "This is a netCDF dimension but not a netCDF variable. %10d"


def _h5py():
    """h5py, or None where it cannot be imported."""
    try:
        import h5py
    except ImportError:
        return None
    return h5py


class NetCDF4File:
    """NetCDF4 (HDF5-backed) file with a small reader/writer API.

    Write modes use the port's encoder (``io/hdf5.py``) everywhere, so
    the machines without h5py write the same file; ``"r"`` reads through
    h5py where it is importable, else through ``io/hdf5.py``'s reader;
    any other mode needs h5py."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        # the encoder tracks creation order (HDF5 link/attr creation-order
        # indexes): netCDF-C enumerates dims/vars/attrs in creation order,
        # and in name order nc_inq_dimname(0) would return the
        # alphabetically first dim instead of the first-defined one.
        if mode in ("w", "w-", "x"):
            self._f = hdf5.open_file(path, mode)
            # netCDF-C stamps every file it creates with _NCProperties
            # (libhdf5 superblock attr); real consumers (ncdump, UPP) carry
            # it through, so we write the same marker.
            self._f.attrs["_NCProperties"] = np.bytes_(
                b"version=2,netcdf=4.9.0,hdf5=1.10.8")
        else:
            h5py = _h5py()
            self._f = (h5py.File(path, mode) if h5py is not None
                       else hdf5.open_file(path, mode))
        self._dimids: dict[str, int] = {}
        if mode == "r":
            for name, ds in self._f.items():
                if self._is_dim(ds):
                    self._dimids[name] = len(self._dimids)

    # -- common ------------------------------------------------------------

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @staticmethod
    def _is_dataset(ds) -> bool:
        h5py = sys.modules.get("h5py")
        return isinstance(ds, hdf5.Dataset) or (
            h5py is not None and isinstance(ds, h5py.Dataset))

    @classmethod
    def _is_dim(cls, ds) -> bool:
        return (cls._is_dataset(ds)
                and ds.attrs.get("CLASS") == b"DIMENSION_SCALE")

    # -- reading -----------------------------------------------------------

    def has_dim(self, name: str) -> bool:
        return name in self._f and self._is_dim(self._f[name])

    def dim_names(self):
        return list(self._dimids)

    def dim_size(self, name: str) -> int:
        return self._f[name].shape[0]

    def has_var(self, name: str) -> bool:
        if name not in self._f:
            return False
        ds = self._f[name]
        if not self._is_dim(ds):
            return True
        # a coordinate variable is both a dim and a variable
        return ds.attrs.get("NAME", b"").startswith(b"%s" % name.encode())

    def var_names(self):
        out = []
        for name, ds in self._f.items():
            if self._is_dataset(ds) and self.has_var(name):
                out.append(name)
        return out

    def var_dims(self, name: str):
        ds = self._f[name]
        out = []
        for i in range(ds.ndim):
            proxy = ds.dims[i]
            out.append(proxy[0].name.lstrip("/") if len(proxy) else None)
        return out

    def read_var(self, name: str):
        return np.asarray(self._f[name][...])

    def var_attrs(self, name: str):
        return {
            k: _decode(v)
            for k, v in self._f[name].attrs.items()
            if not k.startswith("_Netcdf4") and k not in ("CLASS", "NAME", "DIMENSION_LIST", "REFERENCE_LIST")
        }

    def get_attr(self, name: str, default=KeyError):
        try:
            return _decode(self._f.attrs[name])
        except KeyError:
            if default is KeyError:
                raise
            return default

    def global_attr_names(self):
        return [k for k in self._f.attrs if not k.startswith("_NC")]

    # -- writing -----------------------------------------------------------

    def set_attr(self, name: str, value, var: str | None = None):
        target = self._f if var is None else self._f[var]
        if isinstance(value, str):
            # fixed-length bytes -> netCDF-C sees NC_CHAR (text) attrs, the
            # type netcdf-fortran writes (nf90_put_att with character data);
            # h5py's default str mapping would surface as NC_STRING instead.
            # Empty strings use a null dataspace (how netCDF-C stores
            # zero-length text attrs, e.g. stagger="" on mass-point vars).
            if value == "":
                target.attrs[name] = hdf5.Empty(np.dtype("S1"))
            else:
                target.attrs[name] = np.bytes_(value.encode())
        elif isinstance(value, (int, np.integer)):
            target.attrs[name] = np.int32(value)
        elif isinstance(value, float):
            target.attrs[name] = np.float64(value)
        else:
            target.attrs[name] = value

    def create_dim(self, name: str, size: int | None):
        """def_dim: size=None -> unlimited (current size grows on write)."""
        if size is None:
            ds = self._f.create_dataset(name, shape=(0,), maxshape=(None,),
                                        dtype="f4", track_order=True)
        else:
            ds = self._f.create_dataset(name, shape=(size,), dtype="f4",
                                        track_order=True)
        ds.make_scale(_NC_DIM_NAME % (0 if size is None else size))
        ds.attrs["_Netcdf4Dimid"] = np.int32(len(self._dimids))
        self._dimids[name] = len(self._dimids)
        return ds

    def ensure_unlimited_size(self, name: str, size: int):
        ds = self._f[name]
        if ds.shape[0] < size:
            ds.resize((size,))

    def create_var(self, name: str, dims, dtype, data=None, fill=None,
                   compress: bool = False):
        """def_var + optional immediate put_var. dims are dimension names."""
        if compress:
            raise FatalError(f"{name}: compress=True: the port's HDF5 "
                             "encoder stores contiguous data only")
        shape = tuple(self._f[d].shape[0] for d in dims)
        ds = self._f.create_dataset(name, shape=shape, dtype=dtype,
                                    track_order=True)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self._f[d])
        ds.attrs["_Netcdf4Coordinates"] = np.array(
            [self._dimids[d] for d in dims], dtype=np.int32
        )
        if data is not None:
            ds[...] = data
        elif fill is not None:
            ds[...] = fill
        return ds

    def write_var(self, name: str, data):
        self._f[name][...] = data

    def write_var_slab(self, name: str, data, starts):
        """Partial put_var: write ``data`` at offset vector ``starts``
        (the nf90_put_var start/count form — the streaming writer fills
        variables level-block by level-block as strips arrive)."""
        ds = self._f[name]
        sel = tuple(slice(s, s + n) for s, n in zip(starts, np.shape(data)))
        ds[sel] = data


def open_dataset(path: str):
    """nf90_open equivalent: dispatch on file magic (HDF5 vs classic CDF)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(hdf5.MAGIC):
        return NetCDF4File(path, "r")
    if magic[:4] in _CDF_VERSIONS:
        return _CDFReader(path)
    # HDF5 superblock may be at an offset in some files; try h5py anyway
    return NetCDF4File(path, "r")
