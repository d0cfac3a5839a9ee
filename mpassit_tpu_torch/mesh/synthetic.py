"""Synthetic MPAS-like meshes for tests and benchmarks.

The reference ships no fixtures (SURVEY §4: "the reference has no tests"), so
parity is checked against small analytic meshes generated here: a spherical
centroidal-Voronoi-ish mesh from Fibonacci-lattice generators via
scipy.spatial.SphericalVoronoi, exposed with MPAS naming (nCells, nVertices,
verticesOnCell, cellsOnVertex, latCell in radians, ...).
"""

from __future__ import annotations

import numpy as np

from .mpas import MPASMesh, cells_on_vertex_from_regions


def fibonacci_sphere(n: int) -> np.ndarray:
    """n well-spread unit vectors (golden-spiral lattice)."""
    i = np.arange(n, dtype=np.float64)
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    z = 1.0 - (2.0 * i + 1.0) / n
    theta = 2.0 * np.pi * i / phi
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=-1)


def synthetic_voronoi_mesh(ncells: int = 500, nz: int = 4, nsoil: int = 2,
                           seed: int = 0) -> MPASMesh:
    """Global Voronoi mesh over Fibonacci generators (valid MPAS topology:
    every vertex joins exactly 3 cells)."""
    from scipy.spatial import SphericalVoronoi

    pts = fibonacci_sphere(ncells)
    if seed:
        rng = np.random.default_rng(seed)
        pts = pts + 0.05 * rng.standard_normal(pts.shape) / np.sqrt(ncells)
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    sv = SphericalVoronoi(pts, radius=1.0)
    sv.sort_vertices_of_regions()

    verts = sv.vertices / np.linalg.norm(sv.vertices, axis=1, keepdims=True)
    nvertices = len(verts)
    max_edges = max(len(r) for r in sv.regions)
    voc = np.full((ncells, max_edges), -1, dtype=np.int32)
    for c, region in enumerate(sv.regions):
        voc[c, : len(region)] = region

    cov = cells_on_vertex_from_regions(voc, nvertices)

    lat_cell = np.rad2deg(np.arcsin(np.clip(pts[:, 2], -1, 1)))
    lon_cell = np.rad2deg(np.arctan2(pts[:, 1], pts[:, 0]))
    lat_vertex = np.rad2deg(np.arcsin(np.clip(verts[:, 2], -1, 1)))
    lon_vertex = np.rad2deg(np.arctan2(verts[:, 1], verts[:, 0]))

    rng = np.random.default_rng(seed + 1)
    ter = 500.0 + 300.0 * np.sin(np.deg2rad(lat_cell) * 3) + rng.normal(0, 10, ncells)
    zs = 0.05 + 0.2 * np.arange(nsoil, dtype=np.float64) if nsoil else None

    return MPASMesh(
        ncells=ncells, nvertices=nvertices, nz=nz, nzp1=nz + 1,
        max_edges=max_edges, nsoil=nsoil,
        lat_cell=lat_cell, lon_cell=lon_cell,
        lat_vertex=lat_vertex, lon_vertex=lon_vertex,
        vertices_on_cell=voc, cells_on_vertex=cov,
        ter=ter, zs=zs,
    )


def write_mpas_grid_file(mesh: MPASMesh, path: str) -> None:
    """Write the subset of an MPAS grid/init file the pipeline reads
    (model_grid.F90:285-419): dims, latCell/lonCell (radians),
    latVertex/lonVertex, verticesOnCell (1-based, 0-padded, Fortran layout),
    cellsOnVertex, zs, ter."""
    from ..io.nc4 import NetCDF4File

    with NetCDF4File(path, "w") as f:
        f.create_dim("nCells", mesh.ncells)
        f.create_dim("nVertices", mesh.nvertices)
        f.create_dim("nVertLevels", mesh.nz)
        f.create_dim("nVertLevelsP1", mesh.nzp1)
        f.create_dim("maxEdges", mesh.max_edges)
        f.create_dim("nSoilLevels", max(mesh.nsoil, 1))
        f.create_dim("TWO", 2)
        f.create_dim("vertexDegree", 3)
        f.create_dim("Time", None)
        f.ensure_unlimited_size("Time", 1)

        f.create_var("latCell", ("nCells",), "f8", np.deg2rad(mesh.lat_cell))
        f.create_var("lonCell", ("nCells",), "f8",
                     np.deg2rad(np.mod(mesh.lon_cell, 360.0)))
        f.create_var("latVertex", ("nVertices",), "f8", np.deg2rad(mesh.lat_vertex))
        f.create_var("lonVertex", ("nVertices",), "f8",
                     np.deg2rad(np.mod(mesh.lon_vertex, 360.0)))
        # C layout (nCells, maxEdges) == Fortran (maxEdges, nCells)
        f.create_var("verticesOnCell", ("nCells", "maxEdges"), "i4",
                     (mesh.vertices_on_cell + 1).astype(np.int32))
        f.create_var("cellsOnVertex", ("nVertices", "vertexDegree"), "i4",
                     (mesh.cells_on_vertex + 1).astype(np.int32))
        zs = mesh.zs if mesh.zs is not None else np.array([0.05])
        f.create_var("zs", ("nCells", "nSoilLevels"), "f8",
                     np.broadcast_to(zs, (mesh.ncells, len(zs))))
        f.create_var("ter", ("nCells",), "f8", mesh.ter)


_XTIME_STRLEN = 64


def write_mpas_data_file(mesh: MPASMesh, path: str, fields: dict,
                         attrs: dict | None = None,
                         xtime: str = "2024-03-25_09:00:00",
                         field_attrs: dict | None = None,
                         dtype: str = "f8") -> None:
    """Write an MPAS diag/history-style data file.

    fields: name -> array of shape (ncells,), (ncells, nz), (ncells, nzp1),
    (ncells, nsoil) or (nvertices, nz); dimension names inferred from shape.
    attrs: global attributes (config_start_time, config_dt, ...).
    ``fields`` may also map a name to a zero-argument callable returning
    the array — evaluated one at a time so a production-scale file
    (~10 GB) never holds every field in memory at once.
    dtype: on-disk float type ("f8" default; "f4" halves single-precision
    MPAS runs' disk/read footprint, matching the f32 ingest default).
    """
    from ..io.nc4 import NetCDF4File

    field_attrs = field_attrs or {}
    with NetCDF4File(path, "w") as f:
        f.create_dim("nCells", mesh.ncells)
        f.create_dim("nVertices", mesh.nvertices)
        f.create_dim("nVertLevels", mesh.nz)
        f.create_dim("nVertLevelsP1", mesh.nzp1)
        f.create_dim("nSoilLevels", max(mesh.nsoil, 1))
        f.create_dim("StrLen", _XTIME_STRLEN)
        f.create_dim("Time", None)
        f.ensure_unlimited_size("Time", 1)

        lev_dim = {mesh.nz: "nVertLevels", mesh.nzp1: "nVertLevelsP1"}
        if mesh.nsoil and mesh.nsoil not in lev_dim:
            lev_dim[mesh.nsoil] = "nSoilLevels"

        for name, arr in fields.items():
            if callable(arr):
                arr = arr()
            arr = np.asarray(arr, dtype=np.float64 if dtype == "f8"
                             else np.float32)
            loc = "nCells" if arr.shape[0] == mesh.ncells else "nVertices"
            if arr.ndim == 1:
                dims = ("Time", loc)
            else:
                dims = ("Time", loc, lev_dim[arr.shape[1]])
            f.create_var(name, dims, dtype, arr[None])
            fa = field_attrs.get(name, {})
            f.set_attr("units", fa.get("units", "si"), var=name)
            f.set_attr("long_name", fa.get("long_name", name + " field"),
                       var=name)

        xt = np.zeros((1, _XTIME_STRLEN), dtype="S1")
        padded = (xtime + " " * _XTIME_STRLEN)[:_XTIME_STRLEN]
        xt[0] = np.frombuffer(padded.encode(), dtype="S1")
        f.create_var("xtime", ("Time", "StrLen"), "S1", xt)

        for k, v in (attrs or {}).items():
            f.set_attr(k, v)
