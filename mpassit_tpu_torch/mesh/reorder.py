"""Locality reordering of MPAS cells for the windowed Pallas apply.

The reference offers METIS graph-partition files to give each MPI rank a
compact patch (``block_decomp_file``, model_grid.F90:2367-2426). The
TPU-native analog is a *global renumbering*: sort cells into latitude bands
(lat-major, lon within band) or along a target-space Z-curve so that nearby
target tiles reference compact spans of source rows — turning the slab
gather in ops/matmul_apply into near-sequential HBM reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .mpas import MPASMesh


def latitude_band_order(lat_deg, lon_deg, band_deg: float) -> np.ndarray:
    """Permutation sorting points by (lat band, lon)."""
    band = np.floor((np.asarray(lat_deg) + 90.0) / band_deg).astype(np.int64)
    return np.lexsort((np.asarray(lon_deg), band))


def _interleave_bits(a: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each int so consecutive bits are 3 apart
    (int64 2-way Morton uses stride 2; stride 2 version below)."""
    a = a.astype(np.uint64)
    a &= np.uint64(0xFFFFFFFF)
    a = (a | (a << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    a = (a | (a << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    a = (a | (a << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    a = (a | (a << np.uint64(2))) & np.uint64(0x3333333333333333)
    a = (a | (a << np.uint64(1))) & np.uint64(0x5555555555555555)
    return a


def morton_key(iy: np.ndarray, ix: np.ndarray) -> np.ndarray:
    """Z-order (Morton) key of nonnegative integer coordinates (< 2^31)."""
    return (_interleave_bits(np.asarray(iy)) << np.uint64(1)) | _interleave_bits(
        np.asarray(ix))


def grid_morton_order(proj, lat_deg, lon_deg, cell_pts: float) -> np.ndarray:
    """Permutation ordering points along a Z-curve over the TARGET grid's
    (i, j) space, quantized to ``cell_pts`` target points per Morton cell.
    Points projecting outside the grid still get finite keys (clipped), so
    global meshes order cleanly too."""
    from ..grids.projection import latlon_to_ij

    i, j = latlon_to_ij(proj, np.asarray(lat_deg), np.asarray(lon_deg))
    i = np.nan_to_num(i, nan=0.0, posinf=2.0 ** 40, neginf=-(2.0 ** 40))
    j = np.nan_to_num(j, nan=0.0, posinf=2.0 ** 40, neginf=-(2.0 ** 40))
    qi = np.floor(i / cell_pts).astype(np.int64)
    qj = np.floor(j / cell_pts).astype(np.int64)
    # shift (not clip!) to nonnegative: clipping would collapse every
    # off-grid cell onto the boundary key and interleave them with real
    # boundary cells, destroying window locality
    qi = np.clip(qi - qi.min(), 0, 2**20)
    qj = np.clip(qj - qj.min(), 0, 2**20)
    return np.argsort(morton_key(qj, qi), kind="stable")


@dataclasses.dataclass
class ReorderedMesh:
    mesh: MPASMesh
    #: new_id = perm_inv[old_id]; data_new = data_old[perm]
    perm: np.ndarray
    perm_inv: np.ndarray


def reorder_cells(mesh: MPASMesh, perm: np.ndarray) -> ReorderedMesh:
    """Return a new mesh with cells renumbered by ``perm`` (new position k
    holds old cell perm[k]). Vertex numbering is left unchanged (only
    element-located operators are windowed)."""
    perm_inv = np.empty_like(perm)
    perm_inv[perm] = np.arange(len(perm))

    cov = mesh.cells_on_vertex
    cov_new = np.where(cov >= 0, perm_inv[np.clip(cov, 0, None)], -1)

    new = MPASMesh(
        ncells=mesh.ncells, nvertices=mesh.nvertices, nz=mesh.nz,
        nzp1=mesh.nzp1, max_edges=mesh.max_edges, nsoil=mesh.nsoil,
        lat_cell=mesh.lat_cell[perm], lon_cell=mesh.lon_cell[perm],
        lat_vertex=mesh.lat_vertex, lon_vertex=mesh.lon_vertex,
        vertices_on_cell=mesh.vertices_on_cell[perm],
        cells_on_vertex=cov_new.astype(np.int32),
        ter=None if mesh.ter is None else mesh.ter[perm],
        zs=mesh.zs,
    )
    return ReorderedMesh(mesh=new, perm=perm, perm_inv=perm_inv)


def reorder_cells_by_latitude(mesh: MPASMesh, band_deg: float | None = None
                              ) -> ReorderedMesh:
    """Renumber cells into latitude bands (lat-major, lon within band).
    band_deg defaults to ~2 cell spacings."""
    if band_deg is None:
        band_deg = 2.0 * np.rad2deg(mesh.mean_cell_spacing_rad())
    perm = latitude_band_order(mesh.lat_cell, mesh.lon_cell, band_deg)
    return reorder_cells(mesh, perm)


def reorder_cells_morton(mesh: MPASMesh, proj, cell_pts: float = 32.0
                         ) -> ReorderedMesh:
    """Renumber cells along a Z-curve over a target grid's index space —
    the ordering the 2-D-tiled Pallas kernel wants: any compact 2-D tile of
    target points maps to a short contiguous span of source ids."""
    perm = grid_morton_order(proj, mesh.lat_cell, mesh.lon_cell, cell_pts)
    return reorder_cells(mesh, perm)


def apply_perm(data: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Reorder a (ncells, ...) field array into the new numbering."""
    return np.asarray(data)[perm]
