"""Regrid weights at chosen target points, worked out from the mesh and the
grid alone, as MPASSIT defines each method.

- ``bilinear``: a point inside the Delaunay triangle of three cell
  centres (the triangles are the mesh's vertices, ``cellsOnVertex``) takes
  the solution x of x_a A + x_b B + x_c C = P over the unit vectors,
  normalised to sum to 1. A point in no triangle stays unmapped (0).
- ``vertex_bilinear``: the point's Voronoi cell (its nearest centre) is
  fanned into triangles from its first listed corner; the same rule over
  corner vertices in the triangle that holds the point.
- ``nearest``: the nearest cell centre (chord distance).
- ``conservative``: the area of each Voronoi cell's overlap with the
  target cell (its four corners joined by great circles) over the target
  cell's area, not renormalised. Polygons are clipped in the gnomonic
  plane at the target centre, where great circles are straight lines.
- ``quad_bilinear``: a staggered point inside a quad of mass points takes
  the bilinear weights whose map of the quad, in the gnomonic plane at the
  point, hits the point; among the candidate quads the one it lies in
  (least excursion outside [0, 1]^2, the first on ties), clamped onto it
  when it lies outside by less than a hundredth of a cell, else unmapped.
  On a periodic grid the quads of the last column join it to column 0.

Weights are float64 ``(idx, w)`` arrays, one row per point.
"""

from __future__ import annotations

import numpy as np

INSIDE_TOL = 1e-9
QUAD_SLACK = 1e-2


def xyz(lat_rad, lon_rad):
    lat = np.asarray(lat_rad, np.float64)
    lon = np.asarray(lon_rad, np.float64)
    c = np.cos(lat)
    return np.stack([c * np.cos(lon), c * np.sin(lon), np.sin(lat)], -1)


def xyz_deg(lat_deg, lon_deg):
    return xyz(np.radians(lat_deg), np.radians(lon_deg))


class Mesh:
    def __init__(self, m: dict):
        from scipy.spatial import cKDTree

        self.cell = xyz(m["lat_cell"], m["lon_cell"])
        self.vertex = xyz(m["lat_vertex"], m["lon_vertex"])
        self.voc = np.asarray(m["voc"], np.int64)
        self.cov = np.asarray(m["cov"], np.int64)
        self.ncells = len(self.cell)
        self.tree = cKDTree(self.cell)
        d = np.linalg.norm(self.vertex[np.maximum(self.voc, 0)]
                           - self.cell[:, None, :], axis=2)
        #: the largest chord from a centre to one of its corners
        self.r_cell = float(np.where(self.voc >= 0, d, 0.0).max())


def _bary(a, b, c, p):
    """Normalised solution of x_a a + x_b b + x_c c = p, by Cramer's rule,
    rows of (N, 3) vectors; rows with no solution read -1."""
    def det(u, v, w):
        return (u[:, 0] * (v[:, 1] * w[:, 2] - v[:, 2] * w[:, 1])
                - u[:, 1] * (v[:, 0] * w[:, 2] - v[:, 2] * w[:, 0])
                + u[:, 2] * (v[:, 0] * w[:, 1] - v[:, 1] * w[:, 0]))
    x = np.stack([det(p, b, c), det(a, p, c), det(a, b, p)], 1)
    s = x.sum(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = x / s[:, None]
    w[~np.isfinite(w).all(1)] = -1.0
    return w


def _best_triangle(p, tris, verts):
    """p (N, 3); tris (N, K, 3) vertex ids into ``verts`` (-1 padded
    rows ignored). Returns (idx (N, 3), w (N, 3), found (N,))."""
    N, K, _ = tris.shape
    ok = (tris >= 0).all(2)
    t = np.where(tris >= 0, tris, 0).reshape(-1, 3)
    w = _bary(verts[t[:, 0]], verts[t[:, 1]], verts[t[:, 2]],
              np.repeat(p, K, 0)).reshape(N, K, 3)
    score = np.where(ok, w.min(2), -np.inf)
    k = score.argmax(1)
    rows = np.arange(N)
    found = score[rows, k] >= -INSIDE_TOL
    idx = np.where(found[:, None], tris[rows, k], 0)
    ws = np.clip(w[rows, k], 0.0, None)
    ws = np.where(found[:, None], ws / ws.sum(1, keepdims=True), 0.0)
    return idx, ws, found


def bilinear(mesh: Mesh, p, chunk: int = 200_000):
    """Cell-centred bilinear weights at unit vectors ``p`` (N, 3)."""
    N = len(p)
    idx = np.zeros((N, 3), np.int64)
    w = np.zeros((N, 3))
    for lo in range(0, N, chunk):
        sl = slice(lo, min(lo + chunk, N))
        pc = p[sl]
        todo = np.arange(len(pc))
        for k in (1, 4, 12):
            if not len(todo):
                break
            _, near = mesh.tree.query(pc[todo], k=k)
            near = near.reshape(len(todo), -1)
            corners = mesh.voc[near].reshape(len(todo), -1)   # vertex ids
            tris = np.where(corners[:, :, None] >= 0,
                            mesh.cov[np.maximum(corners, 0)], -1)
            i3, w3, found = _best_triangle(pc[todo], tris, mesh.cell)
            rows = lo + todo[found]
            idx[rows], w[rows] = i3[found], w3[found]
            todo = todo[~found]
    return idx, w


def vertex_bilinear(mesh: Mesh, p):
    """Vertex-located bilinear weights at unit vectors ``p`` (N, 3)."""
    _, cell = mesh.tree.query(p)
    voc = mesh.voc[cell]
    nv = (voc >= 0).sum(1)
    K = voc.shape[1] - 2
    s = np.arange(1, K + 1)
    tris = np.stack([np.repeat(voc[:, :1], K, 1), voc[:, 1:K + 1],
                     voc[:, 2:K + 2]], 2)
    tris[s[None, :] + 1 >= nv[:, None]] = -1
    idx, w, _ = _best_triangle(p, tris, mesh.vertex)
    return idx, w


def nearest(mesh: Mesh, p):
    _, cell = mesh.tree.query(p)
    return cell.reshape(-1, 1).astype(np.int64), np.ones((len(p), 1))


# --------------------------------------------------------- conservative ----

def _frame(n):
    ref = np.where(np.abs(n[:, 2:3]) < 0.9, [[0.0, 0.0, 1.0]],
                   [[1.0, 0.0, 0.0]])
    e1 = np.cross(ref, n)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    return e1, np.cross(n, e1)


def _project(v, n, e1, e2):
    """Gnomonic projection of (..., 3) onto the planes at n (per row)."""
    d = np.einsum("p...k,pk->p...", v, n)
    return np.stack([np.einsum("p...k,pk->p...", v, e1) / d,
                     np.einsum("p...k,pk->p...", v, e2) / d], -1)


def _area(poly, cnt):
    """Shoelace area of (P, V, 2) polygons of ``cnt`` vertices."""
    V = poly.shape[1]
    nxt = (np.arange(V)[None, :] + 1) % np.maximum(cnt[:, None], 1)
    q = np.take_along_axis(poly, nxt[:, :, None], 1)
    t = poly[:, :, 0] * q[:, :, 1] - poly[:, :, 1] * q[:, :, 0]
    return 0.5 * np.where(np.arange(V)[None, :] < cnt[:, None], t, 0).sum(1)


def _clip(poly, cnt, a, b):
    """Keep the part of each polygon left of the line a -> b
    (Sutherland-Hodgman, one edge); (P, V, 2) -> (P, V + 1, 2)."""
    P, V, _ = poly.shape
    ex, ey = (b - a)[:, 0:1], (b - a)[:, 1:2]
    side = ex * (poly[:, :, 1] - a[:, 1:2]) - ey * (poly[:, :, 0] - a[:, 0:1])
    out = np.zeros((P, V + 1, 2))
    n = np.zeros(P, np.int64)
    rows = np.arange(P)
    for k in range(V):
        live = k < cnt
        k1 = np.where(k + 1 < cnt, k + 1, 0)
        cur, nxt = poly[:, k], poly[rows, k1]
        sc, sn = side[:, k], side[rows, k1]
        keep = live & (sc >= 0)
        out[rows[keep], n[keep]] = cur[keep]
        n += keep
        cross = live & ((sc >= 0) != (sn >= 0))
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(cross, sc / (sc - sn), 0.0)
        hit = cur + t[:, None] * (nxt - cur)
        out[rows[cross], n[cross]] = hit[cross]
        n += cross
    return out, n


def conservative(mesh: Mesh, centers, corners, chunk: int = 100_000):
    """Overlap fractions of target cells with centre unit vectors
    ``centers`` (N, 3) and corners ``corners`` (N, 4, 3) in order round
    the cell. Returns (target row, cell, fraction) of every pair whose
    fraction passes 1e-12."""
    N = len(centers)
    r_quad = float(np.linalg.norm(corners - centers[:, None, :],
                                  axis=2).max())
    lists = mesh.tree.query_ball_point(centers, r=mesh.r_cell + r_quad)
    counts = np.fromiter((len(c) for c in lists), np.int64, N)
    pt = np.repeat(np.arange(N), counts)
    ps = np.concatenate([np.asarray(c, np.int64) for c in lists]) \
        if N else np.zeros(0, np.int64)
    frac = np.empty(len(pt))
    for lo in range(0, len(pt), chunk):
        t, s = pt[lo:lo + chunk], ps[lo:lo + chunk]
        n = centers[t]
        e1, e2 = _frame(n)
        quad = _project(corners[t], n, e1, e2)
        qa = _area(quad, np.full(len(t), 4))
        quad = np.where((qa < 0)[:, None, None], quad[:, ::-1], quad)
        qa = np.abs(qa)
        vo = mesh.voc[s]
        cnt = (vo >= 0).sum(1)
        poly = _project(mesh.vertex[np.maximum(vo, 0)], n, e1, e2)
        pa = _area(poly, cnt)
        rev = np.where(np.arange(vo.shape[1])[None, :] < cnt[:, None],
                       cnt[:, None] - 1 - np.arange(vo.shape[1])[None, :],
                       np.arange(vo.shape[1])[None, :])
        poly = np.where((pa < 0)[:, None, None],
                        np.take_along_axis(poly, rev[:, :, None], 1), poly)
        for e in range(4):
            poly, cnt = _clip(poly, cnt, quad[:, e], quad[:, (e + 1) % 4])
        frac[lo:lo + chunk] = np.where(qa > 0, _area(poly, cnt) / qa, 0.0)
    keep = frac > 1e-12
    return pt[keep], ps[keep], frac[keep]


# ------------------------------------------------------- quad bilinear ----

def _cross(u, v):
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def _inverse_bilinear(p00, p10, p01, p11):
    """(a, b) with (1-a)(1-b) p00 + a(1-b) p10 + (1-a) b p01 + a b p11 = 0
    for rows of 2-D corners, the root nearest the unit square."""
    e, f = p10 - p00, p01 - p00
    g = p00 - p10 - p01 + p11
    h = -p00
    k2, k1, k0 = _cross(g, f), _cross(e, f) + _cross(h, g), _cross(h, e)
    with np.errstate(divide="ignore", invalid="ignore"):
        lin = np.abs(k2) < 1e-14 * np.maximum(np.abs(k1), 1e-300)
        disc = np.sqrt(np.maximum(k1 * k1 - 4 * k0 * k2, 0.0))
        roots = [np.where(lin, -k0 / k1, (-k1 - disc) / (2 * k2)),
                 np.where(lin, -k0 / k1, (-k1 + disc) / (2 * k2))]
        best = None
        for b in roots:
            den = e + g * b[:, None]
            use_x = np.abs(den[:, 0]) >= np.abs(den[:, 1])
            a = np.where(use_x, (h[:, 0] - f[:, 0] * b) / den[:, 0],
                         (h[:, 1] - f[:, 1] * b) / den[:, 1])
            viol = np.maximum.reduce([-a, a - 1, -b, b - 1,
                                      np.zeros_like(a)])
            viol = np.where(np.isfinite(viol), viol, np.inf)
            if best is None:
                best = (a, b, viol)
            else:
                take = viol < best[2]
                best = tuple(np.where(take, x, y)
                             for x, y in zip((a, b, viol), best))
    a, b, _ = best
    # one Newton step from the closed form
    for _ in range(2):
        q = ((1 - a) * (1 - b))[:, None] * p00 + (a * (1 - b))[:, None] * p10 \
            + ((1 - a) * b)[:, None] * p01 + (a * b)[:, None] * p11
        da = (1 - b)[:, None] * e + b[:, None] * (p11 - p01)
        db = (1 - a)[:, None] * f + a[:, None] * (p11 - p10)
        det = _cross(da, db)
        with np.errstate(divide="ignore", invalid="ignore"):
            sa = _cross(q, db) / det
            sb = _cross(da, q) / det
        ok = np.isfinite(sa) & np.isfinite(sb)
        a = np.where(ok, a - sa, a)
        b = np.where(ok, b - sb, b)
    return a, b


def quad_bilinear(points, mass_xyz, cands, ny, nx, periodic=False):
    """Weights of staggered points from the mass grid.

    points (N, 3); mass_xyz(jq, iq) -> (M, 3) the unit vectors of mass
    points; cands (N, C, 2) candidate quad origins in order, negative or
    out-of-grid ones none. Quad (jq, iq) has the mass points (jq, iq),
    (jq, iq+1), (jq+1, iq), (jq+1, iq+1), column iq+1 taken modulo nx (on a
    periodic grid the quad of column nx - 1 crosses the seam).
    Returns (idx (N, 4) flat mass ids, w (N, 4))."""
    N, C, _ = cands.shape
    e1, e2 = _frame(points)
    best = np.full(N, np.inf)
    idx = np.zeros((N, 4), np.int64)
    w = np.zeros((N, 4))
    last = nx if periodic else nx - 1
    for c in range(C):
        jq, iq = cands[:, c, 0], cands[:, c, 1]
        ok = (jq >= 0) & (iq >= 0) & (jq < ny - 1) & (iq < last)
        if not ok.any():
            continue
        rows = np.nonzero(ok)[0]
        jr, ir = jq[rows], iq[rows]
        i1 = (ir + 1) % nx
        cx = np.stack([mass_xyz(jr, ir), mass_xyz(jr, i1),
                       mass_xyz(jr + 1, ir), mass_xyz(jr + 1, i1)], 1)
        pr = _project(cx, points[rows], e1[rows], e2[rows])
        a, b = _inverse_bilinear(pr[:, 0], pr[:, 1], pr[:, 2], pr[:, 3])
        viol = np.maximum.reduce([-a, a - 1, -b, b - 1, np.zeros_like(a)])
        viol = np.where(np.isfinite(viol), viol, np.inf)
        take = viol < best[rows]
        r = rows[take]
        best[r] = viol[take]
        ac, bc = np.clip(a[take], 0, 1), np.clip(b[take], 0, 1)
        b0, b1 = jr[take] * nx, (jr[take] + 1) * nx
        idx[r] = np.stack([b0 + ir[take], b0 + i1[take], b1 + ir[take],
                           b1 + i1[take]], 1)
        w[r] = np.stack([(1 - ac) * (1 - bc), ac * (1 - bc),
                         (1 - ac) * bc, ac * bc], 1)
    off = best > QUAD_SLACK
    idx[off], w[off] = 0, 0.0
    return idx, w


def u_candidates(j, i, nx, periodic=False):
    """Quads that may hold U point (j, i): its mass row's and the one
    below; on the outermost columns none, unless the grid is periodic,
    where both columns lie in the quad across the seam."""
    c = np.stack([np.stack([j, i - 1], 1), np.stack([j - 1, i - 1], 1)], 1)
    if periodic:
        c[:, :, 1] %= nx
    else:
        c[(i == 0) | (i == nx)] = -1
    return c


def v_candidates(j, i, ny, nx, periodic=False):
    """Quads that may hold V point (j, i): the two of the mass rows below
    and above it; none on the outermost rows (on a periodic grid the poles,
    which ``Reference.staggered`` maps)."""
    c = np.stack([np.stack([j - 1, i], 1), np.stack([j - 1, i - 1], 1)], 1)
    if periodic:
        c[:, :, 1] %= nx
    c[(j == 0) | (j == ny)] = -1
    return c
