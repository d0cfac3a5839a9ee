"""First-order conservative weight generation (ESMF_REGRIDMETHOD_CONSERVE).

Used by the reference for the snow fields (``cons_vars=['snow','snowh']``,
input_data.F90:840; interp.F90:368-416). Each target cell's value is the
area-weighted average of the source Voronoi cells overlapping it:

    W[t, s] = area(target_t ∩ source_s) / area(target_t)

Geometry: all polygons are projected onto the gnomonic plane tangent at each
target cell center (great circles become straight lines, so Voronoi cell
edges are represented exactly; the projection's area distortion is O(h^2)
over a 3-km cell). Overlaps are computed with a fully vectorized
Sutherland–Hodgman clip of every (target, candidate-source) pair against the
target quad's four half-planes — no per-pair Python loops.

Normalization matches ESMF's default ``fracarea`` with
unmappedaction=IGNORE: weights are fractions of the *total* target area, so
partially covered boundary cells are NOT renormalized (quirk Q5 analog);
fully uncovered cells get all-zero rows.
"""

from __future__ import annotations

import numpy as np

from ..mesh.mpas import MPASMesh, lonlat_to_xyz
from .ell import ELLWeights


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def _clip_halfplane(poly, cnt, a, b):
    """Clip padded polygons (P, V, 2) with valid counts cnt (P,) against the
    half-plane left of directed segment a->b (each (P, 2)).

    Returns (poly_out (P, V+2, 2), cnt_out)."""
    P, V, _ = poly.shape
    ex = (b[:, 0] - a[:, 0])[:, None]
    ey = (b[:, 1] - a[:, 1])[:, None]
    dx = poly[:, :, 0] - a[:, 0][:, None]
    dy = poly[:, :, 1] - a[:, 1][:, None]
    d = _cross2(ex, ey, dx, dy)                       # (P, V) signed dist

    slots = np.arange(V)[None, :]
    valid = slots < cnt[:, None]
    nxt = np.where(slots + 1 < cnt[:, None], slots + 1, 0)
    d_next = np.take_along_axis(d, nxt, axis=1)
    v_next = np.take_along_axis(poly, nxt[:, :, None], axis=1)

    inside = d >= 0.0
    inside_next = d_next >= 0.0
    emit_cur = inside & valid
    emit_int = (inside != inside_next) & valid

    with np.errstate(divide="ignore", invalid="ignore"):
        t = d / (d - d_next)
    t = np.where(emit_int, np.clip(t, 0.0, 1.0), 0.0)
    p_int = poly + t[:, :, None] * (v_next - poly)

    n_emit = emit_cur.astype(np.int64) + emit_int.astype(np.int64)
    start = np.cumsum(n_emit, axis=1) - n_emit       # exclusive prefix
    cnt_out = n_emit.sum(axis=1)

    W = V + 2
    out = np.zeros((P, W, 2), dtype=poly.dtype)
    trash = W - 1
    pos_cur = np.where(emit_cur, start, trash)
    pos_int = np.where(emit_int, start + emit_cur, trash)
    # scatter (intersections second so a real emit never lands on trash slot:
    # max real position = V, trash = V+1)
    np.put_along_axis(out, pos_cur[:, :, None], np.where(
        emit_cur[:, :, None], poly, 0.0), axis=1)
    np.put_along_axis(out, pos_int[:, :, None], np.where(
        emit_int[:, :, None], p_int, 0.0), axis=1)
    out[:, trash] = 0.0
    return out, cnt_out


def _poly_area(poly, cnt):
    """Signed shoelace area of padded polygons."""
    P, V, _ = poly.shape
    slots = np.arange(V)[None, :]
    valid = slots < cnt[:, None]
    nxt = np.where(slots + 1 < cnt[:, None], slots + 1, 0)
    v_next = np.take_along_axis(poly, nxt[:, :, None], axis=1)
    terms = _cross2(poly[:, :, 0], poly[:, :, 1], v_next[:, :, 0], v_next[:, :, 1])
    return 0.5 * np.where(valid, terms, 0.0).sum(axis=1)


def _gnomonic(xyz, n, e1, e2):
    """Project unit vectors (..., 3) to the plane tangent at n (per-row)."""
    dn = np.einsum("...j,...j->...", xyz, n)
    x = np.einsum("...j,...j->...", xyz, e1) / dn
    y = np.einsum("...j,...j->...", xyz, e2) / dn
    return x, y


def _pairs_numpy(pt_all, ps_all, n, e1, e2, corners, voc, xyz_vertex,
                 me, chunk):
    """Vectorized NumPy per-pair pipeline (fallback when no C++ compiler is
    available): gnomonic projection, CCW orientation, 4-edge clip, overlap
    fraction. Chunked over pairs to bound the (P, me, 3) temporaries."""
    frac_all = np.empty(len(pt_all), dtype=np.float64)
    for lo in range(0, len(pt_all), chunk):
        hi = min(lo + chunk, len(pt_all))
        pt, ps = pt_all[lo:hi], ps_all[lo:hi]

        # frames / target quads per pair
        npair = n[pt]
        e1p, e2p = e1[pt], e2[pt]
        qx, qy = _gnomonic(corners[pt], npair[:, None, :],
                           e1p[:, None, :], e2p[:, None, :])   # (P, 4)
        quad = np.stack([qx, qy], axis=-1)
        # enforce CCW orientation of the clip quad
        qcnt = np.full(len(pt), 4, dtype=np.int64)
        qarea = _poly_area(quad, qcnt)
        flip = qarea < 0
        quad[flip] = quad[flip, ::-1]
        qarea = np.abs(qarea)

        # source Voronoi polygons per pair, projected
        svoc = voc[ps]                                 # (P, me)
        scnt = (svoc >= 0).sum(axis=1).astype(np.int64)
        sv = xyz_vertex[np.where(svoc >= 0, svoc, 0)]  # (P, me, 3)
        sx, sy = _gnomonic(sv, npair[:, None, :], e1p[:, None, :],
                           e2p[:, None, :])
        spoly = np.stack([sx, sy], axis=-1)
        # orient source polygons CCW too (S-H assumes consistent orientation
        # only for the clip polygon; subject orientation affects area sign)
        sarea = _poly_area(spoly, scnt)
        sflip = sarea < 0
        # reverse only the valid prefix of flipped rows
        idxs = np.arange(me)[None, :]
        rev = np.where(idxs < scnt[:, None], scnt[:, None] - 1 - idxs, idxs)
        spoly[sflip] = np.take_along_axis(
            spoly[sflip], rev[sflip][:, :, None], axis=1
        )

        poly, cnt = spoly, scnt
        for edge in range(4):
            a = quad[:, edge]
            b = quad[:, (edge + 1) % 4]
            poly, cnt = _clip_halfplane(poly, cnt, a, b)
        area = _poly_area(poly, cnt)
        frac_all[lo:hi] = np.where(qarea > 0, area / qarea, 0.0)
    return frac_all


def conservative_weights(mesh: MPASMesh, target_grid,
                         chunk: int = 200_000) -> ELLWeights:
    """Overlap-fraction weights of every source Voronoi cell onto every
    target mass cell. target_grid: grids.target.TargetGrid.

    Candidate pairs come from a SOURCE-side ball query with per-cell radii:
    each source cell fetches the target centers within (its own
    circumradius + the max target circumradius). Target cells are
    near-uniform (a map-projected regular grid), so the bound is tight per
    source cell; the previous target-side query used the GLOBAL max source
    radius, which over-fetched quadratically on variable-resolution meshes
    (66 s -> the candidate set itself dominated at 2.6M cells). This
    replaces ESMF RegridStore's distributed overlap search
    (the reference's interp.F90:372-416)."""
    lat_c, lon_c = target_grid.lat, target_grid.lon
    lat4, lon4 = target_grid.corner_quads()           # (ny, nx, 4)
    dst_shape = lat_c.shape
    T = lat_c.size

    ctr = lonlat_to_xyz(lon_c.reshape(-1), lat_c.reshape(-1))      # (T, 3)
    corners = lonlat_to_xyz(lon4.reshape(-1, 4), lat4.reshape(-1, 4))  # (T,4,3)

    # local tangent frames at target centers
    n = ctr
    ref = np.where(np.abs(n[:, 2:3]) < 0.9,
                   np.array([0.0, 0.0, 1.0]), np.array([1.0, 0.0, 0.0]))
    e1 = np.cross(ref, n)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(n, e1)

    # chord circumradii: per-target (near-uniform) and PER-SOURCE
    r_t_max = np.linalg.norm(
        corners - ctr[:, None, :], axis=2).max() * 1.05
    voc = mesh.vertices_on_cell
    vxyz = mesh.xyz_vertex[np.where(voc >= 0, voc, 0)]
    cxyz = mesh.xyz_cell[:, None, :]
    dv = np.linalg.norm(vxyz - cxyz, axis=2)
    dv = np.where(voc >= 0, dv, 0.0)
    r_s = dv.max(axis=1) * 1.05                        # (ncells,)

    from scipy.spatial import cKDTree

    target_tree = cKDTree(ctr)

    # candidate pairs, collected over source chunks
    me = mesh.max_edges
    S = mesh.ncells
    acc_t: list[np.ndarray] = []
    acc_s: list[np.ndarray] = []
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        sl = slice(lo, hi)
        cand_lists = target_tree.query_ball_point(
            mesh.xyz_cell[sl], r=r_s[sl] + r_t_max, workers=-1
        )
        counts = np.fromiter((len(c) for c in cand_lists), dtype=np.int64,
                             count=hi - lo)
        if counts.sum() == 0:
            continue
        acc_s.append(np.repeat(np.arange(lo, hi), counts))
        acc_t.append(np.concatenate(
            [np.asarray(c, dtype=np.int64) for c in cand_lists]))

    pt = np.concatenate(acc_t) if acc_t else np.zeros(0, dtype=np.int64)
    ps = np.concatenate(acc_s) if acc_s else np.zeros(0, dtype=np.int64)

    from .. import native

    pw = native.conservative_pairs(pt, ps, n, e1, e2, corners, voc,
                                   mesh.xyz_vertex)
    if pw is None:
        pw = _pairs_numpy(pt, ps, n, e1, e2, corners, voc,
                          mesh.xyz_vertex, me, chunk)
    keep = pw > 1e-12
    pt, ps, pw = pt[keep], ps[keep], pw[keep]

    # pack pairs into ELL rows
    order = np.argsort(pt, kind="stable")
    pt, ps, pw = pt[order], ps[order], pw[order]
    row_counts = np.bincount(pt, minlength=T)
    K = int(row_counts.max()) if T else 0
    K = max(K, 1)
    idx = np.zeros((T, K), dtype=np.int32)
    w = np.zeros((T, K), dtype=np.float64)
    indptr = np.concatenate([[0], np.cumsum(row_counts)])
    slot = np.arange(len(pt)) - indptr[pt]
    idx[pt, slot] = ps.astype(np.int32)
    w[pt, slot] = pw
    return ELLWeights(idx=idx, w=w, n_src=mesh.ncells, method="conserve",
                      dst_shape=dst_shape, src_loc="element")
