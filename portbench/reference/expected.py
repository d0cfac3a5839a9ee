"""What MPASSIT's output file holds at the sampled points, worked out from
the configuration, the mesh and the seeded fields alone.

Every variable of the file is listed with the points it is sampled at
("M" mass, "U" and "V" staggers, or "whole" for variables without a
horizontal extent), its levels, its float64 values and the scale its error
is measured against: its largest magnitude, and for T that of theta where
it is larger (T is stored in float32 after theta - 300), 1 where the
variable is all zero.

The writer's transforms (write_data.F90:1339-1475, with ``wrf_mod_vars``):
T = theta - 300; MU, PH and P zero; PB = P_HYD; P_TOP = the least of
0.8 x the top level of P_HYD where that is at least 10, and of P_HYD's
largest value; PHB = zgrid x 9.81; Z_C the midpoints of zgrid, its top
level the NetCDF fill value. XTIME is start minus valid time in minutes,
ITIMESTEP that over the time step. Where the grid rotates (Lambert;
``reference/grid.py``) the file has SINALPHA and COSALPHA, and the 10-m
winds and the mass winds are rotated to grid-relative (u cos a + v sin a,
v cos a - u sin a) before the mass winds are restaggered onto U and V.

On a periodic (global) grid the restagger's quads cross the seam, and the
V points of the outermost rows lie on the poles. There MPASSIT's second
ESMF regrid (bilinear, mass points to the V stagger, interp.F90:313-328;
SURVEY Q6, Q9) meets a source grid with one periodic dimension, for which
ESMF builds an artificial pole: the default ``polemethod`` of a
non-conservative regrid, ESMF_POLEMETHOD_ALLAVG, whose value is the mean
of every source point of the row next to the pole. A point on the pole
takes that value: the mean of the mass winds of row 0 (south) or row
ny - 1 (north).
"""

from __future__ import annotations

import hashlib
import os
from datetime import datetime

import numpy as np

from . import interp
from .grid import target_grid
from .routing import routing, soil_method

NC_FILL_FLOAT = 9.96921e36


class Expect:
    def __init__(self, where, values, scale=None, fill=None):
        self.where = where                   # "M", "U", "V" or "whole"
        self.values = np.asarray(values, np.float64)
        self.fill = fill                     # levels that hold the fill
        if scale is None:
            live = self.values if fill is None else self.values[~fill]
            scale = float(np.abs(live).max()) if live.size else 0.0
        self.scale = scale if scale > 0 else 1.0


def samples(seed: int, ny: int, nx: int, n_mass: int, n_stag: int) -> dict:
    """The points compared, drawn from ``seed``: the mass grid's corners
    and ``n_mass`` points, and ``n_stag`` points of each stagger, a quarter
    of them on its outermost columns (U) or rows (V)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 15]))

    def draw(n, nj, ni):
        k = rng.choice(nj * ni, size=min(n, nj * ni), replace=False)
        return k // ni, k % ni

    jm, im = draw(n_mass, ny, nx)
    jm = np.concatenate([[0, 0, ny - 1, ny - 1], jm])
    im = np.concatenate([[0, nx - 1, 0, nx - 1], im])
    q = n_stag // 4
    ju, iu = draw(n_stag - q, ny, nx + 1)
    ju = np.concatenate([ju, rng.integers(0, ny, q)])
    iu = np.concatenate([iu, rng.choice([0, nx], q)])
    jv, iv = draw(n_stag - q, ny + 1, nx)
    jv = np.concatenate([jv, rng.choice([0, ny], q)])
    iv = np.concatenate([iv, rng.integers(0, nx, q)])
    return {"M": (jm, im), "U": (ju, iu), "V": (jv, iv)}


def _time(s):
    return datetime(int(s[0:4]), int(s[5:7]), int(s[8:10]), int(s[11:13]),
                    int(s[14:16]), int(s[17:19]))


class Reference:
    """The reference of one configuration and seed. ``mesh`` is the mesh
    dict of ``inputs``, ``fields`` the ({diag}, {hist}) FieldSpecs,
    ``cache_dir`` where the full-grid bilinear weights are kept."""

    def __init__(self, cfg: dict, mesh: dict, fields, cache_dir: str):
        self.cfg, self.nml = cfg, cfg["namelist"]
        self.m = mesh
        self.mesh = interp.Mesh(mesh)
        self.diag, self.hist = fields
        self.grid = target_grid(self.nml)
        self.cache_dir = cache_dir

    # -- source values, as the files hold them ---------------------------
    def src(self, name):
        """(n, nlev or 1) float32 values of a field at its locations."""
        if name == "ter":
            return np.asarray(self.m["ter"], np.float64)[:, None]
        spec = self.diag.get(name) or self.hist[name]
        if spec.loc == "vertex":
            a = spec.values(self.m["lat_vertex"], self.m["lon_vertex"])
        else:
            a = spec.values(self.m["lat_cell"], self.m["lon_cell"])
        return a[:, None] if a.ndim == 1 else a

    @staticmethod
    def apply(idx, w, src):
        """(nlev, N) float64 of sum_k w src[idx], by level."""
        out = np.zeros((src.shape[1], len(idx)))
        for k in range(idx.shape[1]):
            out += (w[:, k][None, :]
                    * src[idx[:, k]].astype(np.float64).T)
        return out

    # -- weights at points --------------------------------------------------
    def mass_xyz(self, j, i):
        return interp.xyz_deg(*self.grid.mass(j, i))

    def conservative_at(self, j, i):
        g = self.grid
        c = np.stack([interp.xyz_deg(*g.corner(j, i)),
                      interp.xyz_deg(*g.corner(j, i + 1)),
                      interp.xyz_deg(*g.corner(j + 1, i + 1)),
                      interp.xyz_deg(*g.corner(j + 1, i))], 1)
        return interp.conservative(self.mesh, self.mass_xyz(j, i), c)

    def conservative_apply(self, pairs, n, src):
        pt, ps, fr = pairs
        out = np.zeros((src.shape[1], n))
        np.add.at(out.T, pt, fr[:, None] * src[ps].astype(np.float64))
        return out

    def staggered(self, which, j, i, wind):
        """The restagger onto U (``which`` "U") or V points from the
        rotated mass winds ``wind(jm, im) -> (nz, M)``."""
        g = self.grid
        if which == "U":
            pts = interp.xyz_deg(*g.u(j, i))
            cands = interp.u_candidates(j, i, g.nx, g.periodic)
        else:
            pts = interp.xyz_deg(*g.v(j, i))
            cands = interp.v_candidates(j, i, g.ny, g.nx, g.periodic)
        idx, w = interp.quad_bilinear(pts, self.mass_xyz, cands, g.ny, g.nx,
                                      g.periodic)
        used, inv = np.unique(idx, return_inverse=True)
        vals = wind(used // g.nx, used % g.nx)          # (nz, len(used))
        inv = inv.reshape(idx.shape)
        out = np.zeros((vals.shape[0], len(idx)))
        for k in range(4):
            out += w[:, k][None, :] * vals[:, inv[:, k]]
        if which == "V" and g.periodic:
            for jv, row in ((0, 0), (g.ny, g.ny - 1)):
                pole = j == jv
                if pole.any():
                    out[:, pole] = wind(np.full(g.nx, row),
                                        np.arange(g.nx)).mean(1)[:, None]
        return out

    # -- P_TOP over the whole grid -----------------------------------------
    def full_bilinear(self):
        """Bilinear weights at every mass point, kept in ``cache_dir``."""
        g = self.grid
        h = hashlib.sha256(repr((self.mesh.ncells,)
                                + g.cache_key("bilinear"))
                           .encode()).hexdigest()[:16]
        key = f"refbilinear_{h}.npz"
        path = os.path.join(self.cache_dir, key)
        if os.path.exists(path):
            with np.load(path) as z:
                return z["idx"], z["w"]
        jj, ii = np.divmod(np.arange(g.ny * g.nx), g.nx)
        idx, w = interp.bilinear(self.mesh, self.mass_xyz(jj, ii))
        os.makedirs(self.cache_dir, exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(tmp, idx=idx.astype(np.int32), w=w)
        os.replace(tmp, path)
        return idx, w

    def p_top(self, name, chunk=200_000):
        idx, w = self.full_bilinear()
        src = self.src(name)
        top_min, vmax = np.inf, -np.inf
        for lo in range(0, len(idx), chunk):
            v = self.apply(idx[lo:lo + chunk], w[lo:lo + chunk], src)
            vmax = max(vmax, float(v.max()))
            top = v[-1]
            sel = top >= 10.0
            if sel.any():
                top_min = min(top_min, float((top[sel] * 0.8).min()))
        return min(vmax, top_min)

    # -- the whole file ---------------------------------------------------
    def expected(self, smp: dict) -> dict:
        cfg, nml, g = self.cfg, self.nml, self.grid
        wrf_mod = bool(nml.get("wrf_mod_vars", False))
        r = routing(cfg["varlists"], nml.get("interp_diag", True),
                    nml.get("interp_hist", True), wrf_mod)
        nz, nsoil = cfg["mesh"]["nz"], cfg["mesh"]["nsoil"]
        jm, im = smp["M"]
        S = len(jm)
        out = {}
        lat, lon = g.mass(jm, im)
        out["XLAT"], out["XLONG"] = Expect("M", [lat]), Expect("M", [lon])
        out["MAPFAC_M"] = Expect("M", [g.mapfac(lat)])
        for st, fn in (("U", g.u), ("V", g.v)):
            la, lo = fn(*smp[st])
            out["XLAT_" + st] = Expect(st, [la])
            out["XLONG_" + st] = Expect(st, [lo])
            out["MAPFAC_" + st] = Expect(st, [g.mapfac(la)])
        if g.rotates:
            cosa, sina = g.rotation(jm, im)
            out["SINALPHA"], out["COSALPHA"] = Expect("M", [sina]), Expect(
                "M", [cosa])
        zs = np.zeros(nsoil)
        zs[:] = np.asarray(self.m["zs"], np.float32)[:nsoil]
        out["ZS"] = Expect("whole", zs)
        ci = cfg["inputs"]
        delta = (_time(ci["start_time"]) - _time(ci["valid_time"])
                 ).total_seconds()
        out["XTIME"] = Expect("whole", [delta / 60.0])
        out["ITIMESTEP"] = Expect("whole", [int(delta / ci["config_dt"])])
        out["Times"] = ci["valid_time"][:19]

        pm = self.mass_xyz(jm, im)
        bil = interp.bilinear(self.mesh, pm)
        near = interp.nearest(self.mesh, pm)
        cons = None

        def at(method, name):
            nonlocal cons
            src = self.src(name)
            if method == "bilinear":
                return self.apply(*bil, src)
            if method == "nearest":
                return self.apply(*near, src)
            if cons is None:
                cons = self.conservative_at(jm, im)
            return self.conservative_apply(cons, S, src)

        out["HGT"] = Expect("M", at("bilinear", "ter"))
        diag = {o: at("bilinear", n) for n, o in r["diag"]}
        names = dict(r["diag"])
        if g.rotates and "u10" in names and "v10" in names:
            u, v = diag[names["u10"]], diag[names["v10"]]
            diag[names["u10"]] = u * cosa + v * sina
            diag[names["v10"]] = v * cosa - u * sina
        for o, a in diag.items():
            out[o] = Expect("M", a)
        for n, o in r["cons_2d"]:
            out[o] = Expect("M", at("conserve", n))
        for n, o in r["patch_2d"]:
            out[o] = Expect("M", at("bilinear", n))
        for n, o in r["nstd_2d"]:
            out[o] = Expect("M", at("nearest", n))
        for n, o in r["soil"]:
            out[o] = Expect("M", at(soil_method(r), n))
        for n, o in r["nz_3d"]:
            a = at("bilinear", n)
            if wrf_mod and o == "T":
                # the file stores T in float32: its rounding is relative to
                # |T| where that passes |theta|
                out[o] = Expect("M", a - 300.0, scale=max(
                    np.abs(a).max(), np.abs(a - 300.0).max()))
            else:
                out[o] = Expect("M", a)
            if wrf_mod and o == "MUB":
                out["MU"] = Expect("M", np.zeros((nz, S)))
            if wrf_mod and o == "P_HYD":
                out["P_TOP"] = Expect("whole", [self.p_top(n)])
                out["PB"] = Expect("M", a)
        if r["do_u"] or r["do_v"]:
            def wind(jq, iq):
                p = self.mass_xyz(jq, iq)
                b = interp.bilinear(self.mesh, p)
                u = self.apply(*b, self.src(r["u_var"]))
                v = self.apply(*b, self.src(r["v_var"]))
                if g.rotates and r["do_u"] and r["do_v"]:
                    ca, sa = g.rotation(jq, iq)
                    return {"U": u * ca + v * sa, "V": v * ca - u * sa}
                return {"U": u, "V": v}
            for st, flag in (("U", r["do_u"]), ("V", r["do_v"])):
                if flag:
                    out[st] = Expect(st, self.staggered(
                        st, *smp[st], lambda jq, iq, s=st: wind(jq, iq)[s]))
        for n, o in r["nzp1_3d"]:
            a = at("bilinear", n)
            if o == "PHB":
                zc = np.zeros((nz + 1, S))
                zc[:nz] = 0.5 * (a[1:] + a[:-1])
                zc[nz] = NC_FILL_FLOAT
                fill = np.zeros(zc.shape, bool)
                fill[nz] = True
                out["Z_C"] = Expect("M", zc, fill=fill)
                a = a * 9.81
            out[o] = Expect("M", a)
            if wrf_mod and o == "PHB":
                out["PH"] = Expect("M", np.zeros((nz + 1, S)))
        if r["vert_3d"]:
            vb = interp.vertex_bilinear(self.mesh, pm)
            for n, o in r["vert_3d"]:
                out[o] = Expect("M", self.apply(*vb, self.src(n)))
        if wrf_mod:
            out["P"] = Expect("M", np.zeros((nz, S)))
            if "PB" not in out:
                fill = np.ones((nz, S), bool)
                out["PB"] = Expect("M", np.full((nz, S), NC_FILL_FLOAT),
                                   fill=fill)
        if "Z_C" not in out:
            fill = np.ones((nz + 1, S), bool)
            out["Z_C"] = Expect("M", np.full((nz + 1, S), NC_FILL_FLOAT),
                                fill=fill)
        return out
