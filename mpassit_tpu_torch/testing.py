"""Classic-format (CDF-2) writers for synthetic MPAS inputs.

The JAX package's synthetic writers (``mesh/synthetic.py``) write
NetCDF4/HDF5 through h5py. These write the same variables, dimensions and
attributes as CDF-2 ("64-bit offset") files with ``scipy.io.netcdf_file``
— plain numpy and scipy — which the shared reader (``io/nc4.open_dataset``)
reads without HDF5. ``chip_smoke.py`` uses them on machines without h5py;
the tests drive the port on their files.

``Time`` is a fixed dimension of length 1, not the record dimension:
scipy's reader fails on record data larger than 2 GiB ("buffer size must
be a multiple of element size"), which a 655,362-cell history file with
55 levels exceeds. Variables keep their leading ``Time`` axis.
"""

from __future__ import annotations

import numpy as np

_XTIME_STRLEN = 64


def _netcdf(path):
    from scipy.io import netcdf_file

    return netcdf_file(path, "w", version=2)


def write_grid_file_classic(mesh, path: str) -> None:
    """Classic counterpart of ``mesh.synthetic.write_mpas_grid_file``:
    dims, latCell/lonCell (radians), latVertex/lonVertex, verticesOnCell
    and cellsOnVertex (1-based, 0-padded), zs, ter."""
    with _netcdf(path) as f:
        f.createDimension("Time", 1)
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
                            dtype: str = "f4") -> None:
    """Classic counterpart of ``mesh.synthetic.write_mpas_data_file``.

    fields: name -> array of shape (ncells,), (ncells, nz), (ncells, nzp1),
    (ncells, nsoil) or (nvertices, nz), or a zero-argument callable
    returning it (evaluated one at a time); dimension names are inferred
    from the shape. attrs: global attributes. Each variable gets the
    attributes units="si" and long_name="<name> field"."""
    with _netcdf(path) as f:
        f.createDimension("Time", 1)
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
            arr = np.asarray(arr, dtype=np.float64 if dtype == "f8"
                             else np.float32)
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
