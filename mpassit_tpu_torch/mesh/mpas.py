"""MPAS unstructured Voronoi mesh ingestion.

Replaces the reference's mesh build (``model_grid.F90:252-623``) and the
searchable-mesh role of ``ESMF_MeshCreate``. Instead of distributing the
connectivity across MPI ranks and letting ESMF resolve shared nodes, we hold
the whole mesh on host (the reference also reads the FULL arrays on every
rank, ``model_grid.F90:341-419``) and build:

- degree-wrapped cell/vertex coordinates (quirk Q8: MPAS stores radians;
  degrees wrapped to (-180, 180], ``model_grid.F90:450-453,464-467``);
- 0-based ``verticesOnCell`` / ``cellsOnVertex`` connectivity. The
  ``cellsOnVertex`` triangles ARE the Delaunay dual of the Voronoi cell
  centers — the geometric object ESMF's mesh bilinear interpolates on;
- unit 3-D position vectors and a cKDTree over cell centers for point
  location (the ESMF RegridStore search equivalent).

Device sharding replaces the METIS ``block_decomp_file`` decomposition
(``model_grid.F90:2367-2426``); see parallel/.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import DEG_PER_RAD


def lonlat_to_xyz(lon_deg, lat_deg):
    """Unit-sphere 3-D coordinates from degrees."""
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64))
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    cl = np.cos(lat)
    return np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)], axis=-1)


def _wrap_deg(lon_rad):
    """radians -> degrees in (-180, 180] (model_grid.F90:450-453)."""
    lon = np.asarray(lon_rad, dtype=np.float64) * DEG_PER_RAD
    return np.where(lon > 180.0, lon - 360.0, lon)


@dataclasses.dataclass
class MPASMesh:
    # dims (model_grid.F90:290-339)
    ncells: int
    nvertices: int
    nz: int
    nzp1: int
    max_edges: int
    nsoil: int

    # degrees; cells = Voronoi generators ("elements"), vertices = cell
    # corners ("nodes")
    lat_cell: np.ndarray      # (ncells,)
    lon_cell: np.ndarray
    lat_vertex: np.ndarray    # (nvertices,)
    lon_vertex: np.ndarray

    #: (ncells, max_edges) 0-based vertex ids, -1 padded
    vertices_on_cell: np.ndarray
    #: (nvertices, 3) 0-based cell ids, -1 where missing (mesh boundary)
    cells_on_vertex: np.ndarray

    ter: np.ndarray = None    # (ncells,) terrain height ('ter' -> HGT)
    zs: np.ndarray = None     # (nsoil,) soil layer center depths

    # lazy caches
    _xyz_cell: np.ndarray = dataclasses.field(default=None, repr=False)
    _xyz_vertex: np.ndarray = dataclasses.field(default=None, repr=False)
    _tree: object = dataclasses.field(default=None, repr=False)
    _vtree: object = dataclasses.field(default=None, repr=False)

    @property
    def xyz_cell(self) -> np.ndarray:
        if self._xyz_cell is None:
            self._xyz_cell = lonlat_to_xyz(self.lon_cell, self.lat_cell)
        return self._xyz_cell

    @property
    def xyz_vertex(self) -> np.ndarray:
        if self._xyz_vertex is None:
            self._xyz_vertex = lonlat_to_xyz(self.lon_vertex, self.lat_vertex)
        return self._xyz_vertex

    @property
    def cell_tree(self):
        """cKDTree over cell-center unit vectors (chord metric ~ great circle)."""
        if self._tree is None:
            from scipy.spatial import cKDTree

            self._tree = cKDTree(self.xyz_cell)
        return self._tree

    @property
    def vertex_tree(self):
        if self._vtree is None:
            from scipy.spatial import cKDTree

            self._vtree = cKDTree(self.xyz_vertex)
        return self._vtree

    @property
    def n_edges_on_cell(self) -> np.ndarray:
        return (self.vertices_on_cell >= 0).sum(axis=1).astype(np.int32)

    def complete_triangles(self) -> np.ndarray:
        """(ntri, 3) cell triples of the Delaunay dual (interior vertices)."""
        ok = (self.cells_on_vertex >= 0).all(axis=1)
        return self.cells_on_vertex[ok]

    def mean_cell_spacing_rad(self) -> float:
        """Rough mean cell-center spacing (radians) from mesh density."""
        return float(np.sqrt(4.0 * np.pi / max(self.ncells, 1)))

    def fingerprint(self) -> str:
        """Stable hash for the weight cache key."""
        import hashlib

        h = hashlib.sha256()
        for a in (self.lat_cell, self.lon_cell, self.lat_vertex,
                  self.lon_vertex, self.vertices_on_cell):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]


def cells_on_vertex_from_regions(vertices_on_cell: np.ndarray, nvertices: int):
    """Derive (nvertices, 3) cellsOnVertex from 0-based padded
    verticesOnCell when the grid file lacks it."""
    ncells, me = vertices_on_cell.shape
    counts = np.zeros(nvertices, dtype=np.int32)
    out = np.full((nvertices, 3), -1, dtype=np.int32)
    cells = np.repeat(np.arange(ncells, dtype=np.int32), me)
    verts = vertices_on_cell.reshape(-1)
    mask = verts >= 0
    for c, v in zip(cells[mask], verts[mask]):
        if counts[v] < 3:
            out[v, counts[v]] = c
        counts[v] += 1
    return out


def mesh_from_file(path: str) -> MPASMesh:
    """define_input_grid's reads (model_grid.F90:285-419), minus the
    MPI decomposition (device sharding replaces it)."""
    from ..errors import FatalError, netcdf_guard
    from ..io.nc4 import open_dataset

    # model_grid.F90:288: error_handler("OPENING MPAS INPUT FILE", ...)
    try:
        f = open_dataset(path)
    except (OSError, FileNotFoundError) as e:
        raise FatalError("OPENING MPAS INPUT FILE") from e
    with f:
        # model_grid.F90:293-339: netcdf_err 'reading <dim> id' per dim
        def dim(name):
            with netcdf_guard(f"reading {name} id"):
                return f.dim_size(name)

        ncells = dim("nCells")
        nvertices = dim("nVertices")
        nz = dim("nVertLevels")
        nzp1 = dim("nVertLevelsP1")
        max_edges = dim("maxEdges")
        nsoil = dim("nSoilLevels") if f.has_dim("nSoilLevels") else 0

        def var(name):
            with netcdf_guard(f"reading {name} id"):
                return f.read_var(name)

        lat_cell = np.asarray(var("latCell"), dtype=np.float64) * DEG_PER_RAD
        lon_cell = _wrap_deg(var("lonCell"))
        lat_vertex = np.asarray(var("latVertex"), dtype=np.float64) * DEG_PER_RAD
        lon_vertex = _wrap_deg(var("lonVertex"))

        # file layout (maxEdges, nCells) Fortran = (nCells, maxEdges) C
        voc = np.asarray(var("verticesOnCell"), dtype=np.int64)
        if voc.shape == (max_edges, ncells):
            voc = voc.T
        voc = voc.astype(np.int64) - 1  # 1-based, 0 = pad -> -1

        if f.has_var("cellsOnVertex"):
            cov = np.asarray(f.read_var("cellsOnVertex"), dtype=np.int64)
            if cov.shape == (3, nvertices):
                cov = cov.T
            cov = cov - 1
        else:
            cov = cells_on_vertex_from_regions(
                voc.astype(np.int32), nvertices
            ).astype(np.int64)

        ter = (
            np.asarray(f.read_var("ter"), dtype=np.float64)
            if f.has_var("ter")
            else np.zeros(ncells)
        )
        zs = None
        if f.has_var("zs"):
            z = np.asarray(f.read_var("zs"), dtype=np.float64)
            zs = z.reshape(-1)[:nsoil] if nsoil else z.reshape(-1)

    return MPASMesh(
        ncells=ncells, nvertices=nvertices, nz=nz, nzp1=nzp1,
        max_edges=max_edges, nsoil=nsoil,
        lat_cell=lat_cell, lon_cell=lon_cell,
        lat_vertex=lat_vertex, lon_vertex=lon_vertex,
        vertices_on_cell=voc.astype(np.int32),
        cells_on_vertex=cov.astype(np.int32),
        ter=ter, zs=zs,
    )
