"""Classic-format (CDF-1/CDF-2) writers for synthetic MPAS inputs.

The JAX package's synthetic writers (``mesh/synthetic.py``) write
NetCDF4/HDF5 through h5py. These write the same variables, dimensions and
attributes as classic files ("64-bit offset" CDF-2 by default, CDF-1 with
``version=1``) with ``scipy.io.netcdf_file`` — plain numpy and scipy —
which the port's reader (``io/nc4.open_dataset``) reads without HDF5.
``chip_smoke.py`` uses them on machines without h5py; the tests drive the
port on their files.

``Time`` is the record (unlimited) dimension, as in MPAS's own history and
diag streams; ``record_time=False`` makes it a fixed dimension of length 1.
The port's reader takes record data past 2 GiB (a 655,362-cell history
file with 55 levels has more), which scipy's reader does not. Variables
keep their leading ``Time`` axis either way.

``describe_hdf5`` is the manifest of an HDF5 file's contents (each
dataset's dtype, shape and blake2b digest, each attribute's value, in
order), the same through h5py and through the port's ``io/hdf5`` reader:
tests/nc4_foreign.py writes it for the committed netCDF-C fixtures of
tests/data/nc4_foreign, and the tests and ``chip_smoke.py`` hold the
port's reader to it.
"""

from __future__ import annotations

import hashlib

import numpy as np

_XTIME_STRLEN = 64


def _netcdf(path, version, record_time):
    from scipy.io import netcdf_file

    f = netcdf_file(path, "w", version=version)
    f.createDimension("Time", None if record_time else 1)
    return f


def write_grid_file_classic(mesh, path: str, *, version: int = 2,
                            record_time: bool = True) -> None:
    """Classic counterpart of ``mesh.synthetic.write_mpas_grid_file``:
    dims, latCell/lonCell (radians), latVertex/lonVertex, verticesOnCell
    and cellsOnVertex (1-based, 0-padded), zs, ter."""
    with _netcdf(path, version, record_time) as f:
        for name, n in (("nCells", mesh.ncells),
                        ("nVertices", mesh.nvertices),
                        ("nVertLevels", mesh.nz), ("nVertLevelsP1", mesh.nzp1),
                        ("maxEdges", mesh.max_edges),
                        ("nSoilLevels", max(mesh.nsoil, 1)), ("TWO", 2),
                        ("vertexDegree", 3)):
            f.createDimension(name, n)

        def var(name, dims, dtype, data):
            f.createVariable(name, dtype, dims)[:] = data

        var("latCell", ("nCells",), "f8", np.deg2rad(mesh.lat_cell))
        var("lonCell", ("nCells",), "f8",
            np.deg2rad(np.mod(mesh.lon_cell, 360.0)))
        var("latVertex", ("nVertices",), "f8", np.deg2rad(mesh.lat_vertex))
        var("lonVertex", ("nVertices",), "f8",
            np.deg2rad(np.mod(mesh.lon_vertex, 360.0)))
        var("verticesOnCell", ("nCells", "maxEdges"), "i4",
            (mesh.vertices_on_cell + 1).astype(np.int32))
        var("cellsOnVertex", ("nVertices", "vertexDegree"), "i4",
            (mesh.cells_on_vertex + 1).astype(np.int32))
        zs = mesh.zs if mesh.zs is not None else np.array([0.05])
        var("zs", ("nCells", "nSoilLevels"), "f8",
            np.broadcast_to(zs, (mesh.ncells, len(zs))))
        var("ter", ("nCells",), "f8", mesh.ter)


def write_data_file_classic(mesh, path: str, fields: dict,
                            attrs: dict | None = None,
                            xtime: str = "2024-03-25_09:00:00",
                            dtype: str = "f4", *, version: int = 2,
                            record_time: bool = True) -> None:
    """Classic counterpart of ``mesh.synthetic.write_mpas_data_file``.

    fields: name -> array of shape (ncells,), (ncells, nz), (ncells, nzp1),
    (ncells, nsoil) or (nvertices, nz), or a zero-argument callable
    returning it (evaluated one at a time); dimension names are inferred
    from the shape; dtype: their numpy type ("f4", "f8", "i2", "i4").
    attrs: global attributes. Each variable gets the attributes units="si"
    and long_name="<name> field"."""
    with _netcdf(path, version, record_time) as f:
        for name, n in (("nCells", mesh.ncells),
                        ("nVertices", mesh.nvertices),
                        ("nVertLevels", mesh.nz), ("nVertLevelsP1", mesh.nzp1),
                        ("nSoilLevels", max(mesh.nsoil, 1)),
                        ("StrLen", _XTIME_STRLEN)):
            f.createDimension(name, n)

        lev_dim = {mesh.nz: "nVertLevels", mesh.nzp1: "nVertLevelsP1"}
        if mesh.nsoil and mesh.nsoil not in lev_dim:
            lev_dim[mesh.nsoil] = "nSoilLevels"

        for name, arr in fields.items():
            if callable(arr):
                arr = arr()
            arr = np.asarray(arr, dtype=dtype)
            loc = "nCells" if arr.shape[0] == mesh.ncells else "nVertices"
            dims = ("Time", loc) if arr.ndim == 1 else (
                "Time", loc, lev_dim[arr.shape[1]])
            v = f.createVariable(name, dtype, dims)
            v[0] = arr
            v.units = "si"
            v.long_name = name + " field"

        padded = (xtime + " " * _XTIME_STRLEN)[:_XTIME_STRLEN]
        xt = f.createVariable("xtime", "c", ("Time", "StrLen"))
        xt[0] = np.frombuffer(padded.encode(), dtype="S1")
        for k, v in (attrs or {}).items():
            setattr(f, k, v)


# ---- HDF5 manifests ------------------------------------------------------

def _jsonable(v):
    """An attribute value as h5py returns it, in JSON: numpy scalars and
    arrays with their dtype, bytes as latin-1 text, str as is."""
    if isinstance(v, (bytes, np.bytes_)):
        return {"bytes": bytes(v).decode("latin-1")}
    if isinstance(v, str):
        return {"str": v}
    if type(v).__name__ == "Empty":        # h5py's or io/hdf5's
        return {"empty": v.dtype.str}
    a = np.asarray(v)
    if a.dtype.kind == "O":
        return {"objects": [_jsonable(x) for x in a.reshape(-1)],
                "shape": list(a.shape)}
    if a.dtype.names:
        return {"compound": str(a.dtype), "shape": list(a.shape)}
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "value": a.reshape(-1).tolist()}


def digest(a) -> str:
    """blake2b of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def describe_hdf5(f) -> dict:
    """What a file holds, read through ``f`` (an h5py file or the port's
    ``io/hdf5`` reader; both expose items(), attrs, dtype, shape): per
    dataset in iteration order its dtype, shape, digest and attributes
    (REFERENCE_LIST and DIMENSION_LIST, which hold file addresses, by
    their shape only), and the root's attributes, each in order."""
    def attrs(obj):
        return [[k, {"references": list(np.shape(v))}
                 if k in ("REFERENCE_LIST", "DIMENSION_LIST")
                 else _jsonable(v)] for k, v in obj.attrs.items()]

    out = {"attrs": attrs(f), "datasets": []}
    for name, ds in f.items():
        a = ds[...]
        out["datasets"].append({"name": name, "dtype": a.dtype.str,
                                "shape": list(a.shape), "digest": digest(a),
                                "attrs": attrs(ds)})
    return out
