"""WPS-style map projection math, vectorized over whole index arrays.

Replaces the reference's ``module_map_utils.F90`` + ``llxy_module.F90``.
Where the reference computes every grid point with a scalar subroutine call
inside a double loop (``model_grid.F90:2212-2217``), everything here is a
single broadcast expression over (ny, nx) index arrays in float64 on the
host — grid construction is one-time setup work; the TPU owns the per-field
hot path (see ops/apply.py).

Supported projections:

- the namelist-selectable set (``program_setup.F90:169-192``): Lambert
  conformal (``module_map_utils.F90:1083-1290``), polar stereographic
  (``:682-822``), Mercator (``:1293-1362``), lat-lon (``:1365-1428``);
- the file-path set reachable through a wrfout/geo_em MAP_PROJ code:
  WGS84 polar stereographic (``:825-946``), Albers NAD83 (``:947-1082``),
  cylindrical (``:1431-1511``), Cassini / rotated pole (``:1512-1658``),
  Gaussian (``:1901-2214``). Note the reference has NO inverse (ij->latlon)
  for Gaussian — its ij_to_latlon aborts on PROJ_GAUSS — we provide one by
  interpolating the Gaussian latitudes (a conscious extension).

PROJ_ROTLL (the NMM E-grid rotated lat-lon, ``:1660-1900``) is deliberately
excluded: it is unreachable through MPASSIT — the target-file reader
requires ARW C-grid coordinate fields (XLAT_U/XLAT_V,
``model_grid.F90:1399-1460``) that NMM E-grid files do not carry, and the
namelist path never offers it (``program_setup.F90:169-192``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (
    A_NAD83,
    A_WGS84,
    DEG_PER_RAD,
    E_NAD83,
    E_WGS84,
    EARTH_RADIUS_M,
    M,
    PROJ_ALBERS_NAD83,
    PROJ_CASSINI,
    PROJ_CYL,
    PROJ_GAUSS,
    PROJ_LATLON,
    PROJ_LC,
    PROJ_MERC,
    PROJ_PS,
    PROJ_PS_WGS84,
    RAD_PER_DEG,
    U,
    V,
    CORNER,
)


@dataclasses.dataclass(frozen=True)
class ProjInfo:
    """Projection parameters (cf. proj_info, module_map_utils.F90:140-192)."""

    code: int
    lat1: float = -999.9      # known-point latitude
    lon1: float = -999.9      # known-point longitude
    dx: float = -999.9        # grid spacing (m) at truelats
    latinc: float = -999.9    # lat-lon grids only (deg)
    loninc: float = -999.9
    stdlon: float = -999.9
    truelat1: float = -999.9
    truelat2: float = -999.9
    knowni: float = -999.9    # i of known point
    knownj: float = -999.9
    re_m: float = EARTH_RADIUS_M
    nxmin: int = 1            # lat-lon periodic wrap bounds
    nxmax: int = 43200
    # Cassini rotated pole (module_map_utils.F90:163-166)
    lat0: float = 90.0
    lon0: float = 0.0
    comp_ll: bool = False     # inputs already in computational lat/lon
    # Gaussian (module_map_utils.F90:176: nlat = zeros pole->equator)
    nlat: int = 0
    # derived
    hemi: float = 1.0
    cone: float = -999.9
    polei: float = -999.9
    polej: float = -999.9
    rsw: float = -999.9
    rebydx: float = -999.9
    dlon_merc: float = -999.9
    # Albers derived (set_albers_nad83)
    nc_alb: float = -999.9
    bigc: float = -999.9
    rho0: float = -999.9
    # Gaussian latitudes, north-first (tuple keeps the dataclass hashable)
    gauss_lat: tuple = ()


def lc_cone(truelat1: float, truelat2: float) -> float:
    """Cone factor of a Lambert conformal projection (module_map_utils.F90:1124-1157)."""
    if abs(truelat1 - truelat2) > 0.1:
        return (
            np.log10(np.cos(truelat1 * RAD_PER_DEG))
            - np.log10(np.cos(truelat2 * RAD_PER_DEG))
        ) / (
            np.log10(np.tan((45.0 - abs(truelat1) / 2.0) * RAD_PER_DEG))
            - np.log10(np.tan((45.0 - abs(truelat2) / 2.0) * RAD_PER_DEG))
        )
    return np.sin(abs(truelat1) * RAD_PER_DEG)


def _wrap_lon(lon):
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    lon = np.where(lon < -180.0, lon + 360.0, lon)
    return lon


def _ps_wgs84_t(sinphi):
    """Ellipsoidal half-colatitude function t(phi) (llij_ps_wgs84)."""
    e = E_WGS84
    return np.sqrt(((1.0 - sinphi) / (1.0 + sinphi))
                   * ((1.0 + e * sinphi) / (1.0 - e * sinphi)) ** e)


def _ps_wgs84_m(sinphi):
    """Ellipsoidal parallel-circle radius factor m(phi)."""
    cosphi = np.sqrt(np.clip(1.0 - sinphi * sinphi, 0.0, None))
    return cosphi / np.sqrt(1.0 - (E_WGS84 * sinphi) ** 2)


def _albers_q(sinphi):
    """Authalic-latitude auxiliary q(phi) (set_albers_nad83)."""
    e = E_NAD83
    return (1.0 - e * e) * (
        sinphi / (1.0 - (e * sinphi) ** 2)
        - 1.0 / (2.0 * e) * np.log((1.0 - e * sinphi) / (1.0 + e * sinphi))
    )


def gaussian_latitudes(nlat2: int) -> np.ndarray:
    """Gaussian latitudes (degrees, north first) for nlat2 = 2*nlat total
    rows. The reference finds Legendre roots with Newton iteration
    (lggaus, module_map_utils.F90:1965-2030); numpy's Golub-Welsch
    leggauss produces the same roots to machine precision."""
    nodes, _ = np.polynomial.legendre.leggauss(nlat2)
    lats = np.degrees(np.arcsin(nodes))     # ascending (south first)
    return lats[::-1].copy()                # north first


def make_proj(
    code: int,
    *,
    lat1: float = -999.9,
    lon1: float = -999.9,
    knowni: float = -999.9,
    knownj: float = -999.9,
    dx: float = -999.9,
    latinc: float = -999.9,
    loninc: float = -999.9,
    stdlon: float = -999.9,
    truelat1: float = -999.9,
    truelat2: float = -999.9,
    lat0: float = 90.0,
    lon0: float = 0.0,
    comp_ll: bool = False,
    nlat: int = 0,
    nxmax: int = 43200,
    re_m: float = EARTH_RADIUS_M,
) -> ProjInfo:
    """map_set equivalent (module_map_utils.F90:243-567): validates and
    precomputes pole location / cone / radii."""
    lon1 = float(_wrap_lon(np.float64(lon1))) if lon1 != -999.9 else lon1
    stdlon = float(_wrap_lon(np.float64(stdlon))) if stdlon != -999.9 else stdlon
    if truelat2 != -999.9 and abs(truelat2) > 90.0:
        truelat2 = truelat1
    hemi = -1.0 if (truelat1 != -999.9 and truelat1 < 0.0) else 1.0
    rebydx = re_m / dx if dx > 0 else -999.9
    cone = polei = polej = rsw = dlon_merc = -999.9
    nc_alb = bigc = rho0 = -999.9
    gauss_lat: tuple = ()

    if code == PROJ_LC:
        # set_lc (module_map_utils.F90:1083-1121)
        cone = float(lc_cone(truelat1, truelat2))
        deltalon1 = float(_wrap_lon(np.float64(lon1 - stdlon)))
        ctl1r = np.cos(truelat1 * RAD_PER_DEG)
        rsw = (
            rebydx
            * ctl1r
            / cone
            * (
                np.tan((90.0 * hemi - lat1) * RAD_PER_DEG / 2.0)
                / np.tan((90.0 * hemi - truelat1) * RAD_PER_DEG / 2.0)
            )
            ** cone
        )
        arg = cone * (deltalon1 * RAD_PER_DEG)
        polei = hemi * knowni - hemi * rsw * np.sin(arg)
        polej = hemi * knownj + rsw * np.cos(arg)
    elif code == PROJ_PS:
        # set_ps (module_map_utils.F90:682-715)
        reflon = stdlon + 90.0
        scale_top = 1.0 + hemi * np.sin(truelat1 * RAD_PER_DEG)
        ala1 = lat1 * RAD_PER_DEG
        rsw = rebydx * np.cos(ala1) * scale_top / (1.0 + hemi * np.sin(ala1))
        alo1 = (lon1 - reflon) * RAD_PER_DEG
        polei = knowni - rsw * np.cos(alo1)
        polej = knownj - hemi * rsw * np.sin(alo1)
    elif code == PROJ_MERC:
        # set_merc (module_map_utils.F90:1293-1317)
        clain = np.cos(RAD_PER_DEG * truelat1)
        dlon_merc = dx / (re_m * clain)
        rsw = 0.0
        if lat1 != 0.0:
            rsw = np.log(np.tan(0.5 * ((lat1 + 90.0) * RAD_PER_DEG))) / dlon_merc
    elif code == PROJ_PS_WGS84:
        # set_ps_wgs84 (module_map_utils.F90:825-853): pole location on the
        # WGS84 ellipsoid in grid units relative to the known point
        h = hemi
        st1 = np.sin(h * truelat1 * RAD_PER_DEG)
        mc = _ps_wgs84_m(st1)
        tc = _ps_wgs84_t(st1)
        t = _ps_wgs84_t(np.sin(h * lat1 * RAD_PER_DEG))
        rho = h * (A_WGS84 / dx) * mc * t / tc
        polei = rho * np.sin((h * lon1 - h * stdlon) * RAD_PER_DEG)
        polej = -rho * np.cos((h * lon1 - h * stdlon) * RAD_PER_DEG)
    elif code == PROJ_ALBERS_NAD83:
        # set_albers_nad83 (module_map_utils.F90:956-1013)
        h = hemi
        m1 = np.cos(h * truelat1 * RAD_PER_DEG) / np.sqrt(
            1.0 - (E_NAD83 * np.sin(h * truelat1 * RAD_PER_DEG)) ** 2)
        m2 = np.cos(h * truelat2 * RAD_PER_DEG) / np.sqrt(
            1.0 - (E_NAD83 * np.sin(h * truelat2 * RAD_PER_DEG)) ** 2)
        q1 = _albers_q(np.sin(truelat1 * RAD_PER_DEG))
        q2 = _albers_q(np.sin(truelat2 * RAD_PER_DEG))
        if truelat1 == truelat2:
            nc_alb = np.sin(truelat1 * RAD_PER_DEG)
        else:
            nc_alb = (m1 * m1 - m2 * m2) / (q2 - q1)
        bigc = m1 * m1 + nc_alb * q1
        q = _albers_q(np.sin(lat1 * RAD_PER_DEG))
        rho0 = h * (A_NAD83 / dx) * np.sqrt(bigc - nc_alb * q) / nc_alb
        theta = nc_alb * (lon1 - stdlon) * RAD_PER_DEG
        polei = rho0 * np.sin(h * theta)
        polej = rho0 - rho0 * np.cos(h * theta)
    elif code == PROJ_CYL:
        hemi = 1.0                        # set_cyl (:1431-1440)
    elif code == PROJ_CASSINI:
        # set_cassini (:1512-1540): for a rotated non-global domain, lat1 /
        # lon1 are converted to computational coordinates up front
        hemi = 1.0
        global_domain = (
            abs(lat1 - latinc / 2.0 + 90.0) < 0.001
            and abs(np.mod(lon1 - loninc / 2.0 - stdlon, 360.0)) < 0.001)
        if abs(lat0) != 90.0 and not global_domain:
            clat, clon = rotate_coords(lat1, lon1, lat0, lon0, stdlon, -1)
            lat1, lon1 = float(clat), float(clon + stdlon)
    elif code == PROJ_GAUSS:
        gauss_lat = tuple(gaussian_latitudes(nlat * 2))
        # set_gauss (:1925-1938): flip if the data starts at the south pole
        if abs(gauss_lat[0] - lat1) > 0.01:
            gauss_lat = tuple(-g for g in gauss_lat)
        if abs(gauss_lat[0] - lat1) > 0.01:
            raise ValueError("Gaussian_latitude_computation")
    elif code == PROJ_LATLON:
        pass
    else:
        raise ValueError(f"unsupported projection code {code}")

    return ProjInfo(
        code=code, lat1=lat1, lon1=lon1, dx=dx, latinc=latinc, loninc=loninc,
        stdlon=stdlon, truelat1=truelat1, truelat2=truelat2, knowni=knowni,
        knownj=knownj, re_m=re_m, nxmax=nxmax, hemi=hemi, cone=float(cone),
        polei=float(polei), polej=float(polej), rsw=float(rsw),
        rebydx=float(rebydx), dlon_merc=float(dlon_merc),
        lat0=lat0, lon0=lon0, comp_ll=comp_ll, nlat=nlat,
        nc_alb=float(nc_alb), bigc=float(bigc), rho0=float(rho0),
        gauss_lat=gauss_lat,
    )


def proj_from_config(cfg) -> ProjInfo:
    """push_source_projection equivalent (llxy_module.F90:38-159)."""
    code = cfg.proj_code
    if code == PROJ_LATLON:
        return make_proj(
            code,
            lat1=cfg.known_lat, lon1=cfg.known_lon,
            knowni=cfg.known_x, knownj=cfg.known_y,
            latinc=cfg.dlatdeg, loninc=cfg.dlondeg,
            nxmax=int(round(360.0 / cfg.dlondeg)),
        )
    if code == PROJ_MERC:
        return make_proj(
            code, truelat1=cfg.truelat1,
            lat1=cfg.known_lat, lon1=cfg.known_lon,
            knowni=cfg.known_x, knownj=cfg.known_y, dx=cfg.dxkm,
        )
    if code in (PROJ_LC, PROJ_PS):
        return make_proj(
            code, truelat1=cfg.truelat1, truelat2=cfg.truelat2,
            stdlon=cfg.stand_lon,
            lat1=cfg.known_lat, lon1=cfg.known_lon,
            knowni=cfg.known_x, knownj=cfg.known_y, dx=cfg.dxkm,
        )
    raise ValueError(f"unsupported projection code {code}")


# ---------------------------------------------------------------------------
# (i, j) -> (lat, lon) — vectorized ij_to_latlon (module_map_utils.F90:629-679)
# ---------------------------------------------------------------------------

def ij_to_latlon(proj: ProjInfo, i, j):
    i = np.asarray(i, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64)
    if proj.code == PROJ_LATLON:
        return _ijll_latlon(proj, i, j)
    if proj.code == PROJ_LC:
        return _ijll_lc(proj, i, j)
    if proj.code == PROJ_PS:
        return _ijll_ps(proj, i, j)
    if proj.code == PROJ_MERC:
        return _ijll_merc(proj, i, j)
    if proj.code == PROJ_PS_WGS84:
        return _ijll_ps_wgs84(proj, i, j)
    if proj.code == PROJ_ALBERS_NAD83:
        return _ijll_albers(proj, i, j)
    if proj.code == PROJ_CYL:
        return _ijll_cyl(proj, i, j)
    if proj.code == PROJ_CASSINI:
        return _ijll_cassini(proj, i, j)
    if proj.code == PROJ_GAUSS:
        return _ijll_gauss(proj, i, j)
    raise ValueError(f"unsupported projection code {proj.code}")


def latlon_to_ij(proj: ProjInfo, lat, lon):
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    if proj.code == PROJ_LATLON:
        return _llij_latlon(proj, lat, lon)
    if proj.code == PROJ_LC:
        return _llij_lc(proj, lat, lon)
    if proj.code == PROJ_PS:
        return _llij_ps(proj, lat, lon)
    if proj.code == PROJ_MERC:
        return _llij_merc(proj, lat, lon)
    if proj.code == PROJ_PS_WGS84:
        return _llij_ps_wgs84(proj, lat, lon)
    if proj.code == PROJ_ALBERS_NAD83:
        return _llij_albers(proj, lat, lon)
    if proj.code == PROJ_CYL:
        return _llij_cyl(proj, lat, lon)
    if proj.code == PROJ_CASSINI:
        return _llij_cassini(proj, lat, lon)
    if proj.code == PROJ_GAUSS:
        return _llij_gauss(proj, lat, lon)
    raise ValueError(f"unsupported projection code {proj.code}")


def _ijll_lc(proj, i, j):
    """module_map_utils.F90:1160-1233 (ijll_lc)."""
    chi1 = (90.0 - proj.hemi * proj.truelat1) * RAD_PER_DEG
    chi2 = (90.0 - proj.hemi * proj.truelat2) * RAD_PER_DEG
    inew = proj.hemi * i
    jnew = proj.hemi * j
    xx = inew - proj.polei
    yy = proj.polej - jnew
    r2 = xx * xx + yy * yy
    r = np.sqrt(r2) / proj.rebydx
    lon = proj.stdlon + DEG_PER_RAD * np.arctan2(proj.hemi * xx, yy) / proj.cone
    lon = np.mod(lon + 360.0, 360.0)
    if chi1 == chi2:
        chi = 2.0 * np.arctan(
            np.power(r / np.tan(chi1), 1.0 / proj.cone) * np.tan(chi1 * 0.5)
        )
    else:
        chi = 2.0 * np.arctan(
            np.power(r * proj.cone / np.sin(chi1), 1.0 / proj.cone)
            * np.tan(chi1 * 0.5)
        )
    lat = (90.0 - chi * DEG_PER_RAD) * proj.hemi
    # pole point (r2 == 0)
    lat = np.where(r2 == 0.0, proj.hemi * 90.0, lat)
    lon = np.where(r2 == 0.0, proj.stdlon, lon)
    return lat, _wrap_lon(lon)


def _llij_lc(proj, lat, lon):
    """module_map_utils.F90:1236-1290 (llij_lc)."""
    deltalon = _wrap_lon(lon - proj.stdlon)
    ctl1r = np.cos(proj.truelat1 * RAD_PER_DEG)
    rm = (
        proj.rebydx
        * ctl1r
        / proj.cone
        * np.power(
            np.tan((90.0 * proj.hemi - lat) * RAD_PER_DEG / 2.0)
            / np.tan((90.0 * proj.hemi - proj.truelat1) * RAD_PER_DEG / 2.0),
            proj.cone,
        )
    )
    arg = proj.cone * (deltalon * RAD_PER_DEG)
    i = proj.polei + proj.hemi * rm * np.sin(arg)
    j = proj.polej - rm * np.cos(arg)
    return proj.hemi * i, proj.hemi * j


def _ijll_ps(proj, i, j):
    """module_map_utils.F90:763-822 (ijll_ps)."""
    reflon = proj.stdlon + 90.0
    scale_top = 1.0 + proj.hemi * np.sin(proj.truelat1 * RAD_PER_DEG)
    xx = i - proj.polei
    yy = (j - proj.polej) * proj.hemi
    r2 = xx ** 2 + yy ** 2
    gi2 = (proj.rebydx * scale_top) ** 2
    with np.errstate(invalid="ignore", divide="ignore"):
        lat = DEG_PER_RAD * proj.hemi * np.arcsin((gi2 - r2) / (gi2 + r2))
        arccos = np.arccos(np.clip(xx / np.sqrt(np.where(r2 == 0, 1.0, r2)), -1.0, 1.0))
    lon = np.where(yy > 0, reflon + DEG_PER_RAD * arccos, reflon - DEG_PER_RAD * arccos)
    lat = np.where(r2 == 0.0, proj.hemi * 90.0, lat)
    lon = np.where(r2 == 0.0, reflon, lon)
    return lat, _wrap_lon(lon)


def _llij_ps(proj, lat, lon):
    """module_map_utils.F90:718-760 (llij_ps)."""
    reflon = proj.stdlon + 90.0
    scale_top = 1.0 + proj.hemi * np.sin(proj.truelat1 * RAD_PER_DEG)
    ala = lat * RAD_PER_DEG
    rm = proj.rebydx * np.cos(ala) * scale_top / (1.0 + proj.hemi * np.sin(ala))
    alo = (lon - reflon) * RAD_PER_DEG
    return proj.polei + rm * np.cos(alo), proj.polej + proj.hemi * rm * np.sin(alo)


def _ijll_merc(proj, i, j):
    """module_map_utils.F90:1344-1362 (ijll_merc)."""
    lat = (
        2.0 * np.arctan(np.exp(proj.dlon_merc * (proj.rsw + j - proj.knownj)))
        * DEG_PER_RAD
        - 90.0
    )
    lon = (i - proj.knowni) * proj.dlon_merc * DEG_PER_RAD + proj.lon1
    return lat, _wrap_lon(lon)


def _llij_merc(proj, lat, lon):
    """module_map_utils.F90:1320-1341 (llij_merc)."""
    deltalon = _wrap_lon(lon - proj.lon1)
    i = proj.knowni + deltalon / (proj.dlon_merc * DEG_PER_RAD)
    j = (
        proj.knownj
        + np.log(np.tan(0.5 * ((lat + 90.0) * RAD_PER_DEG))) / proj.dlon_merc
        - proj.rsw
    )
    return i, j


def _ijll_latlon(proj, i, j):
    """module_map_utils.F90:1398-1428 (ijll_latlon) incl. periodic wrap."""
    span = proj.nxmax - proj.nxmin + 1
    i_work = np.where(i < proj.nxmin - 0.5, i + span, i)
    i_work = np.where(i_work >= proj.nxmax + 0.5, i_work - span, i_work)
    lat = proj.lat1 + (j - proj.knownj) * proj.latinc
    lon = proj.lon1 + (i_work - proj.knowni) * proj.loninc
    return lat, lon


def _llij_latlon(proj, lat, lon):
    """module_map_utils.F90:1365-1395 (llij_latlon)."""
    i = (lon - proj.lon1) / proj.loninc + proj.knowni
    j = (lat - proj.lat1) / proj.latinc + proj.knownj
    span = proj.nxmax - proj.nxmin + 1
    i = np.where(i < proj.nxmin - 0.5, i + span, i)
    i = np.where(i >= proj.nxmax + 0.5, i - span, i)
    return i, j


# --- file-path projections (module_map_utils.F90:825-1082, 1431-1658,
#     1901-2214) -------------------------------------------------------------

def _llij_ps_wgs84(proj, lat, lon):
    """llij_ps_wgs84 (module_map_utils.F90:856-903): polar stereographic on
    the WGS84 ellipsoid."""
    h = proj.hemi
    st1 = np.sin(h * proj.truelat1 * RAD_PER_DEG)
    mc = _ps_wgs84_m(st1)
    tc = _ps_wgs84_t(st1)
    t = _ps_wgs84_t(np.sin(h * lat * RAD_PER_DEG))
    rho = (A_WGS84 / proj.dx) * mc * t / tc
    i = h * rho * np.sin((h * lon - h * proj.stdlon) * RAD_PER_DEG)
    j = h * (-rho) * np.cos((h * lon - h * proj.stdlon) * RAD_PER_DEG)
    return proj.knowni + (i - proj.polei), proj.knownj + (j - proj.polej)


def _ijll_ps_wgs84(proj, i, j):
    """ijll_ps_wgs84 (module_map_utils.F90:906-946): inverse via the
    conformal-latitude trigonometric series."""
    h = proj.hemi
    x = i - proj.knowni + proj.polei
    y = j - proj.knownj + proj.polej
    st1 = np.sin(h * proj.truelat1 * RAD_PER_DEG)
    mc = _ps_wgs84_m(st1)
    tc = _ps_wgs84_t(st1)
    rho = np.sqrt((x * proj.dx) ** 2 + (y * proj.dx) ** 2)
    t = rho * tc / (A_WGS84 * mc)
    lon = h * proj.stdlon * RAD_PER_DEG + h * np.arctan2(h * x, h * (-y))
    chi = np.pi / 2.0 - 2.0 * np.arctan(t)
    e2 = E_WGS84 ** 2
    a = e2 / 2.0 + 5.0 / 24.0 * e2 ** 2 + e2 ** 3 / 40.0 + 73.0 / 2016.0 * e2 ** 4
    b = 7.0 / 24.0 * e2 ** 2 + 29.0 / 120.0 * e2 ** 3 + 54113.0 / 40320.0 * e2 ** 4
    c = 7.0 / 30.0 * e2 ** 3 + 81.0 / 280.0 * e2 ** 4
    d = 4279.0 / 20160.0 * e2 ** 4
    c2 = np.cos(2.0 * chi)
    lat = chi + np.sin(2.0 * chi) * (a + c2 * (b + c2 * (c + d * c2)))
    return h * lat * DEG_PER_RAD, _wrap_lon(lon * DEG_PER_RAD)


def _llij_albers(proj, lat, lon):
    """llij_albers_nad83 (module_map_utils.F90:1016-1053)."""
    h = proj.hemi
    q = _albers_q(np.sin(h * lat * RAD_PER_DEG))
    rho = h * (A_NAD83 / proj.dx) * np.sqrt(proj.bigc - proj.nc_alb * q) \
        / proj.nc_alb
    theta = proj.nc_alb * (h * lon - h * proj.stdlon) * RAD_PER_DEG
    i = h * rho * np.sin(theta)
    j = h * proj.rho0 - h * rho * np.cos(theta)
    return proj.knowni + (i - proj.polei), proj.knownj + (j - proj.polej)


def _ijll_albers(proj, i, j):
    """ijll_albers_nad83 (module_map_utils.F90:1056-1082): inverse via the
    authalic-latitude series."""
    h = proj.hemi
    e2 = E_NAD83 ** 2
    x = i - proj.knowni + proj.polei
    y = j - proj.knownj + proj.polej
    rho = np.sqrt(x ** 2 + (proj.rho0 - y) ** 2)
    theta = np.arctan2(x, proj.rho0 - y)
    q = (proj.bigc - (rho * proj.nc_alb * proj.dx / A_NAD83) ** 2) / proj.nc_alb
    beta = np.arcsin(q / (1.0 - np.log((1.0 - E_NAD83) / (1.0 + E_NAD83))
                          * (1.0 - e2) / (2.0 * E_NAD83)))
    a = e2 / 3.0 + 31.0 / 180.0 * e2 ** 2 + 517.0 / 5040.0 * e2 ** 3
    b = 23.0 / 360.0 * e2 ** 2 + 251.0 / 3780.0 * e2 ** 3
    c = 761.0 / 45360.0 * e2 ** 3
    lat = beta + a * np.sin(2 * beta) + b * np.sin(4 * beta) + c * np.sin(6 * beta)
    lon = proj.stdlon + theta * DEG_PER_RAD / proj.nc_alb
    return h * lat * DEG_PER_RAD, _wrap_lon(lon)


def _llij_cyl(proj, lat, lon):
    """llij_cyl (module_map_utils.F90:1443-1476): equidistant cylindrical
    anchored at (lat1, lon1)."""
    deltalon = lon - proj.lon1
    deltalon = np.where(deltalon < 0.0, deltalon + 360.0, deltalon)
    deltalon = np.where(deltalon > 360.0, deltalon - 360.0, deltalon)
    i = deltalon / proj.loninc + proj.knowni
    j = (lat - proj.lat1) / proj.latinc + proj.knownj
    ni = 360.0 / proj.loninc
    i = np.where(i <= 0.0, i + ni, i)
    i = np.where(i > ni, i - ni, i)
    return i, j


def _ijll_cyl(proj, i, j):
    """ijll_cyl (module_map_utils.F90:1478-1510)."""
    i_work = i - proj.knowni
    j_work = j - proj.knownj
    ni = 360.0 / proj.loninc
    i_work = np.where(i_work < 0.0, i_work + ni, i_work)
    i_work = np.where(i_work >= ni, i_work - ni, i_work)
    lat = j_work * proj.latinc + proj.lat1
    lon = i_work * proj.loninc + proj.lon1
    return lat, _wrap_lon(lon)


def rotate_coords(ilat, ilon, lat_np, lon_np, lon_0, direction=1):
    """Rotated-pole transform (rotate_coords, module_map_utils.F90:1600-1658).
    direction >= 0: computational -> geographic; < 0: the inverse."""
    ilat = np.asarray(ilat, dtype=np.float64)
    ilon = np.asarray(ilon, dtype=np.float64)
    phi_np = lat_np * RAD_PER_DEG
    lam_np = lon_np * RAD_PER_DEG
    lam_0 = lon_0 * RAD_PER_DEG
    rlat = ilat * RAD_PER_DEG
    rlon = ilon * RAD_PER_DEG
    dlam = (np.pi - lam_0) if direction < 0 else lam_np
    sinphi = (np.cos(phi_np) * np.cos(rlat) * np.cos(rlon - dlam)
              + np.sin(phi_np) * np.sin(rlat))
    cosphi = np.sqrt(np.clip(1.0 - sinphi * sinphi, 0.0, None))
    coslam = (np.sin(phi_np) * np.cos(rlat) * np.cos(rlon - dlam)
              - np.cos(phi_np) * np.sin(rlat))
    sinlam = np.cos(rlat) * np.sin(rlon - dlam)
    safe = cosphi != 0.0
    coslam = np.where(safe, coslam / np.where(safe, cosphi, 1.0), coslam)
    sinlam = np.where(safe, sinlam / np.where(safe, cosphi, 1.0), sinlam)
    olat = DEG_PER_RAD * np.arcsin(np.clip(sinphi, -1.0, 1.0))
    olon = DEG_PER_RAD * (np.arctan2(sinlam, coslam) - dlam - lam_0 + lam_np)
    olon = np.mod(olon + 180.0, 360.0) - 180.0
    return olat, olon


def _llij_cassini(proj, lat, lon):
    """llij_cassini (module_map_utils.F90:1543-1567): geographic ->
    computational rotation, then the cylindrical transform."""
    if abs(proj.lat0) != 90.0 and not proj.comp_ll:
        clat, clon = rotate_coords(lat, lon, proj.lat0, proj.lon0,
                                   proj.stdlon, -1)
        clon = clon + proj.stdlon
    else:
        clat, clon = lat, lon
    return _llij_cyl(proj, clat, clon)


def _ijll_cassini(proj, i, j):
    """ijll_cassini (module_map_utils.F90:1570-1594)."""
    clat, clon = _ijll_cyl(proj, i, j)
    if abs(proj.lat0) != 90.0 and not proj.comp_ll:
        return rotate_coords(clat, clon - proj.stdlon, proj.lat0, proj.lon0,
                             proj.stdlon, 1)
    return clat, clon


def _llij_gauss(proj, lat, lon):
    """llij_gauss (module_map_utils.F90:2130-2212): linear i in longitude;
    j by bracketing the Gaussian latitudes and interpolating linearly
    (vectorized with searchsorted over the monotonic latitude table)."""
    glat = np.asarray(proj.gauss_lat)                 # north first
    n2 = glat.size
    i = (lon - proj.lon1) / proj.loninc + 1.0

    descending = glat[0] > glat[-1]
    table = -glat if descending else glat             # ascending for search
    key = -np.asarray(lat, dtype=np.float64) if descending else lat
    # n_low: 1-based index with glat[n] .. glat[n+1] bracketing lat
    n_low = np.clip(np.searchsorted(table, key, side="left"), 1, n2 - 1)
    g_lo = glat[n_low - 1]
    g_hi = glat[n_low]
    with np.errstate(divide="ignore", invalid="ignore"):
        j = ((g_lo - lat) * (n_low + 1) + (lat - g_hi) * n_low) / (g_lo - g_hi)
    # poleward of the first/last Gaussian row: clamp (the reference picks
    # whichever end is closer, :2173-2184)
    past_start = np.abs(lat) > np.abs(glat[0])
    j = np.where(past_start & (np.abs(lat - glat[0])
                               < np.abs(lat - glat[-1])), 1.0, j)
    j = np.where(past_start & (np.abs(lat - glat[0])
                               >= np.abs(lat - glat[-1])), float(n2), j)
    span = proj.nxmax - proj.nxmin + 1
    i = np.where(i < proj.nxmin - 0.5, i + span, i)
    i = np.where(i >= proj.nxmax + 0.5, i - span, i)
    return i, j


def _ijll_gauss(proj, i, j):
    """Inverse Gaussian transform. The reference HAS none (its ij_to_latlon
    aborts on PROJ_GAUSS, module_map_utils.F90:629-679 DEFAULT case); we
    interpolate the Gaussian latitude table linearly in j — the exact
    inverse of _llij_gauss between rows."""
    glat = np.asarray(proj.gauss_lat)
    n2 = glat.size
    span = proj.nxmax - proj.nxmin + 1
    i_work = np.where(i < proj.nxmin - 0.5, i + span, i)
    i_work = np.where(i_work >= proj.nxmax + 0.5, i_work - span, i_work)
    lon = (i_work - 1.0) * proj.loninc + proj.lon1
    jc = np.clip(j, 1.0, float(n2))
    n_low = np.clip(np.floor(jc).astype(np.int64), 1, n2 - 1)
    frac = jc - n_low
    lat = glat[n_low - 1] + frac * (glat[n_low] - glat[n_low - 1])
    return lat, _wrap_lon(lon)


# ---------------------------------------------------------------------------
# Stagger-aware grid coordinate fields
# ---------------------------------------------------------------------------

_STAGGER_OFFSET = {M: (0.0, 0.0), U: (-0.5, 0.0), V: (0.0, -0.5), CORNER: (-0.5, -0.5)}


def stagger_latlon(proj: ProjInfo, ni: int, nj: int, stagger: int = M):
    """lat/lon arrays (nj, ni) for 1-based grid indices at the given stagger.

    Combines xytoll's stagger offsets (llxy_module.F90:182-203) with
    get_lat_lon_fields' index sweep (model_grid.F90:2188-2219); returns
    row-major (j, i)-indexed arrays.
    """
    di, dj = _STAGGER_OFFSET[stagger]
    ii = np.arange(1, ni + 1, dtype=np.float64)[None, :] + di
    jj = np.arange(1, nj + 1, dtype=np.float64)[:, None] + dj
    ii, jj = np.broadcast_arrays(ii, jj)
    return ij_to_latlon(proj, ii, jj)


def map_factor(proj: ProjInfo, lat):
    """Vectorized get_map_factor (model_grid.F90:2229-2365). Returns (mx, my)."""
    lat = np.asarray(lat, dtype=np.float64)
    if proj.code == PROJ_LC:
        if proj.truelat1 != proj.truelat2:
            colat1 = RAD_PER_DEG * (90.0 - proj.truelat1)
            colat2 = RAD_PER_DEG * (90.0 - proj.truelat2)
            n = (np.log(np.sin(colat1)) - np.log(np.sin(colat2))) / (
                np.log(np.tan(colat1 / 2.0)) - np.log(np.tan(colat2 / 2.0))
            )
            colat = RAD_PER_DEG * (90.0 - lat)
            mx = (
                np.sin(colat2)
                / np.sin(colat)
                * np.power(np.tan(colat / 2.0) / np.tan(colat2 / 2.0), n)
            )
        else:
            colat0 = RAD_PER_DEG * (90.0 - proj.truelat1)
            colat = RAD_PER_DEG * (90.0 - lat)
            mx = (
                np.sin(colat0)
                / np.sin(colat)
                * np.power(np.tan(colat / 2.0) / np.tan(colat0 / 2.0), np.cos(colat0))
            )
        return mx, mx
    if proj.code == PROJ_PS:
        mx = (1.0 + np.sin(RAD_PER_DEG * abs(proj.truelat1))) / (
            1.0 + np.sin(RAD_PER_DEG * np.sign(proj.truelat1 or 1.0) * lat)
        )
        return mx, mx
    if proj.code == PROJ_MERC:
        colat0 = RAD_PER_DEG * (90.0 - proj.truelat1)
        colat = RAD_PER_DEG * (90.0 - lat)
        mx = np.sin(colat0) / np.sin(colat)
        return mx, mx
    if proj.code == PROJ_LATLON:
        # The namelist path never calls get_map_factor for PROJ_LATLON in the
        # reference (it falls through every branch, leaving mapfac
        # *uninitialized*); we define mapfac=1 — a conscious deviation.
        one = np.ones_like(lat)
        return one, one
    raise ValueError(f"unsupported projection code {proj.code}")


def rotation_angle(lat, lon):
    """Vectorized get_rotang (model_grid.F90:2450-2507): (cosa, sina) from the
    local grid-northward direction. lat/lon are (nj, ni); differences taken
    along j (the reference's second index) with one-sided stencils at the
    j boundaries."""
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    d_lon = np.empty_like(lon)
    d_lat = np.empty_like(lat)
    d_lon[1:-1, :] = lon[2:, :] - lon[:-2, :]
    d_lat[1:-1, :] = lat[2:, :] - lat[:-2, :]
    d_lon[0, :] = lon[1, :] - lon[0, :]
    d_lat[0, :] = lat[1, :] - lat[0, :]
    d_lon[-1, :] = lon[-1, :] - lon[-2, :]
    d_lat[-1, :] = lat[-1, :] - lat[-2, :]
    d_lon = np.where(d_lon > 180.0, d_lon - 360.0, d_lon)
    d_lon = np.where(d_lon < -180.0, d_lon + 360.0, d_lon)
    alpha = np.arctan2(
        -np.cos(lat * RAD_PER_DEG) * (d_lon * RAD_PER_DEG), d_lat * RAD_PER_DEG
    )
    return np.cos(alpha), np.sin(alpha)
