"""Bilinear weight generation on the MPAS Voronoi mesh.

Replaces ``ESMF_FieldBundleRegridStore(regridmethod=BILINEAR)`` for both
element-located fields (cell centers — the overwhelmingly common case,
interp.F90:119-347) and node-located fields (vertices — the ``vorticity``
bundle, interp.F90:350-366).

Semantics (the parity oracle of DESIGN.md):

- element-located: the dual of the Voronoi generators is the Delaunay
  triangulation whose triangles are exactly the MPAS vertices
  (``cellsOnVertex``). A target point P inside dual triangle (A, B, C)
  gets the normalized solution x of  x_a·A + x_b·B + x_c·C = P  over the
  unit-sphere position vectors (planar barycentric of the gnomonic
  projection; linear-precision on the tangent plane).
- node-located: the containing Voronoi cell is the nearest generator's;
  its corner polygon is fan-triangulated from its first listed vertex
  (deterministic "triangulation choice", SURVEY §8.3) and the same
  barycentric rule is applied in the containing sub-triangle.

Unmapped points (outside the dual hull on regional meshes) get all-zero
rows — quirk Q5 (unmappedaction=IGNORE leaves the destination untouched).

Everything is vectorized NumPy float64 over flat pair lists; no per-point
Python loops.
"""

from __future__ import annotations

import numpy as np

from ..mesh.mpas import MPASMesh, lonlat_to_xyz
from .ell import ELLWeights

#: relative tolerance for "inside the triangle" (barycentric >= -TOL)
TOL = 1.0e-9


def _triple(a, b, c):
    """Row-wise scalar triple product det[a b c]."""
    return np.einsum("ij,ij->i", a, np.cross(b, c))


def _bary(pa, pb, pc, p):
    """Normalized barycentric coords of p in spherical triangles (rows)."""
    d = _triple(pa, pb, pc)
    xa = _triple(p, pb, pc)
    xb = _triple(pa, p, pc)
    xc = _triple(pa, pb, p)
    s = xa + xb + xc
    # sign-normalize by d so orientation doesn't matter; degenerate -> unmapped
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.stack([xa, xb, xc], axis=1) / s[:, None]
    bad = (np.abs(d) < 1e-300) | (np.abs(s) < 1e-300) | ~np.isfinite(w).all(axis=1)
    w[bad] = -1.0
    return w


def _select_best(tgt_ids, cand_w, n_tgt):
    """Per-target pick the candidate with the largest min-barycentric.
    Returns (best_pair_index_per_target, best_minw_per_target)."""
    if len(tgt_ids) == 0:
        return (np.full(n_tgt, -1, dtype=np.int64),
                np.full(n_tgt, -np.inf))
    minw = cand_w.min(axis=1)
    order = np.lexsort((minw, tgt_ids))
    t_sorted = tgt_ids[order]
    # last occurrence of each target id in the sorted list = its max minw
    last = np.searchsorted(t_sorted, np.arange(n_tgt), side="right") - 1
    first = np.searchsorted(t_sorted, np.arange(n_tgt), side="left")
    has = last >= first
    best_pair = np.where(has, order[np.clip(last, 0, None)], -1)
    best_minw = np.where(has, minw[np.clip(best_pair, 0, None)], -np.inf)
    return best_pair, best_minw


def _cell_incident_triangles(mesh: MPASMesh):
    """Dense padded cell -> incident complete dual triangles table.

    Returns (tris, table) with tris (ntri, 3) cell ids and table
    (ncells, max_incident) triangle ids, -1 padded. A cell is incident to at
    most max_edges triangles (one per corner vertex)."""
    tris = mesh.complete_triangles()          # (ntri, 3) cell ids
    ntri = len(tris)
    flat_cells = tris.reshape(-1)
    tri_ids = np.repeat(np.arange(ntri, dtype=np.int64), 3)
    order = np.argsort(flat_cells, kind="stable")
    sorted_cells = flat_cells[order]
    sorted_tris = tri_ids[order]
    indptr = np.searchsorted(sorted_cells, np.arange(mesh.ncells + 1))
    counts = indptr[1:] - indptr[:-1]
    width = int(counts.max()) if len(counts) else 0
    table = np.full((mesh.ncells, width), -1, dtype=np.int64)
    # slot position of each entry within its cell's row
    slot = np.arange(len(sorted_cells)) - indptr[sorted_cells]
    table[sorted_cells, slot] = sorted_tris
    return tris, table


def bilinear_cell_weights(mesh: MPASMesh, lat, lon, n_query: int = 3,
                          chunk: int = 400_000) -> ELLWeights:
    """Element-located bilinear: K=3 barycentric weights over the corner
    cells of the containing Delaunay-dual triangle. Targets are processed in
    chunks to bound the candidate-pair working set at CONUS scale."""
    lat = np.asarray(lat, dtype=np.float64)
    dst_shape = lat.shape
    p = lonlat_to_xyz(np.asarray(lon).reshape(-1), lat.reshape(-1))
    T = p.shape[0]

    tris, table = _cell_incident_triangles(mesh)
    xyz = mesh.xyz_cell

    idx = np.zeros((T, 3), dtype=np.int32)
    w = np.zeros((T, 3), dtype=np.float64)

    from .. import native

    tri_xyz = None
    if native.get_lib() is not None:
        tri_xyz = xyz[tris]                       # (ntri, 3, 3)

    def locate(pc, rows, k):
        """Fill idx/w for targets pc (global row ids `rows`) using the
        triangles incident to their k nearest cells; returns the row ids
        still unmapped."""
        Tc = pc.shape[0]
        _, near = mesh.cell_tree.query(pc, k=k, workers=-1)
        near = near.reshape(Tc, -1)
        cand = table[near].reshape(Tc, -1)        # (Tc, k*width), -1 padded
        if cand.shape[1] == 0:
            # a mesh so sparse no cell has incident triangles (regional
            # fixtures): everything stays unmapped (quirk Q5); the NumPy
            # argmax below would choke on the zero-width candidate axis
            return rows

        if tri_xyz is not None:
            best, wsel = native.bary_locate(pc, cand, tri_xyz)
            best_minw = np.where(best >= 0, wsel.min(axis=1), -np.inf)
            mapped = best_minw >= -TOL
            tri_ids = cand[np.arange(Tc)[mapped], best[mapped]]
            idx[rows[mapped]] = tris[tri_ids].astype(np.int32)
            wm = np.clip(wsel[mapped], 0.0, None)
            w[rows[mapped]] = wm / wm.sum(axis=1, keepdims=True)
            return rows[~mapped]

        W = cand.shape[1]
        safe = np.where(cand >= 0, cand, 0)
        tri_cells = tris[safe.reshape(-1)]        # (Tc*W, 3)
        w_cand = _bary(
            xyz[tri_cells[:, 0]], xyz[tri_cells[:, 1]], xyz[tri_cells[:, 2]],
            np.repeat(pc, W, axis=0),
        )
        minw = w_cand.min(axis=1).reshape(Tc, W)
        minw[cand < 0] = -np.inf
        best = np.argmax(minw, axis=1)            # padded argmax, no sort
        best_minw = minw[np.arange(Tc), best]
        mapped = best_minw >= -TOL
        sel = best[mapped] + np.arange(Tc)[mapped] * W
        idx[rows[mapped]] = tri_cells[sel].astype(np.int32)
        wm = np.clip(w_cand[sel], 0.0, None)
        w[rows[mapped]] = wm / wm.sum(axis=1, keepdims=True)
        return rows[~mapped]

    for lo in range(0, T, chunk):
        hi = min(lo + chunk, T)
        rows = np.arange(lo, hi)
        # stage 1: the nearest cell's incident triangles contain the point in
        # the overwhelming majority of cases (the containing Delaunay
        # triangle almost always has the nearest generator as a corner)
        missing = locate(p[lo:hi], rows, 1)
        if len(missing):
            # stage 2: widen the search for the stragglers
            missing = locate(p[missing], missing, max(n_query, 4))
        # remaining rows stay unmapped (quirk Q5)

    return ELLWeights(idx=idx, w=w, n_src=mesh.ncells, method="bilinear",
                      dst_shape=dst_shape, src_loc="element")


def bilinear_vertex_weights(mesh: MPASMesh, lat, lon) -> ELLWeights:
    """Node-located bilinear (the vorticity path): fan-triangulate the
    containing Voronoi cell's corner polygon, K=3 barycentric weights over
    vertices."""
    lat = np.asarray(lat, dtype=np.float64)
    dst_shape = lat.shape
    p = lonlat_to_xyz(np.asarray(lon).reshape(-1), lat.reshape(-1))
    T = p.shape[0]

    _, cell = mesh.cell_tree.query(p, workers=-1)  # containing Voronoi cell
    voc = mesh.vertices_on_cell[cell]              # (T, maxEdges)
    nv = (voc >= 0).sum(axis=1)

    # fan triangles (v0, v_s, v_{s+1}) for s in 1..nv-2
    max_fan = mesh.max_edges - 2
    tgt_ids = []
    tri_verts = []
    for s in range(1, max_fan + 1):
        sel = nv >= s + 2
        if not sel.any():
            break
        v0 = voc[sel, 0]
        va = voc[sel, s]
        vb = voc[sel, s + 1]
        tgt_ids.append(np.nonzero(sel)[0])
        tri_verts.append(np.stack([v0, va, vb], axis=1))
    tgt_ids = np.concatenate(tgt_ids)
    tri_verts = np.concatenate(tri_verts).astype(np.int64)

    xyz = mesh.xyz_vertex
    w_cand = _bary(xyz[tri_verts[:, 0]], xyz[tri_verts[:, 1]],
                   xyz[tri_verts[:, 2]], p[tgt_ids])
    best_pair, best_minw = _select_best(tgt_ids, w_cand, T)
    mapped = best_minw >= -TOL

    idx = np.zeros((T, 3), dtype=np.int32)
    w = np.zeros((T, 3), dtype=np.float64)
    bp = best_pair[mapped]
    idx[mapped] = tri_verts[bp].astype(np.int32)
    w[mapped] = np.clip(w_cand[bp], 0.0, None)
    w[mapped] /= w[mapped].sum(axis=1, keepdims=True)
    return ELLWeights(idx=idx, w=w, n_src=mesh.nvertices, method="bilinear",
                      dst_shape=dst_shape, src_loc="node")
