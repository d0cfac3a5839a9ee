"""The WRF target grid of a Lambert conformal namelist, from Snyder's
formulas (Map Projections: A Working Manual, USGS PP 1395, ch. 15).

The namelist's ``nx``/``ny`` count the staggered points: the mass grid is
``(nx - 1) x (ny - 1)``. The known point ``(ref_x, ref_y)`` (1-based,
the mass grid's middle when both are absent) sits at
``(ref_lat, ref_lon)``. Mass point ``(j, i)`` (0-based) is grid index
``(i + 1, j + 1)``; the U stagger is half a point west, the V stagger half
a point south, the corners both. The sphere's radius is WRF's, 6,370 km.

Map factors are Snyder's k = n rho / (R cos phi). The rotation angle is
MPASSIT's (model_grid.F90:2450-2507): alpha = atan2(-cos(lat) dlon, dlat)
with dlat, dlon differences along j, central inside and one-sided on the
first and last rows, dlon wrapped into [-180, 180]. MPASSIT turns the
winds to grid-relative and writes SINALPHA/COSALPHA for this projection
(write_data.F90:447-477). The grid is not periodic.
"""

from __future__ import annotations

import math

import numpy as np

EARTH_RADIUS_M = 6370000.0


def _wrap(lon):
    lon = np.asarray(lon, np.float64)
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    return np.where(lon < -180.0, lon + 360.0, lon)


class Lambert:
    rotates = True
    periodic = False

    def __init__(self, nml: dict):
        self.nx = int(nml["nx"]) - 1           # mass points west-east
        self.ny = int(nml["ny"]) - 1
        self.dx = float(nml["dx"])
        p1 = math.radians(float(nml["truelat1"]))
        p2 = math.radians(float(nml.get("truelat2", nml["truelat1"])))
        if p1 <= 0 or p2 <= 0:
            raise ValueError("the reference grid takes northern Lambert "
                             "grids only")
        if abs(p1 - p2) > math.radians(0.1):
            self.n = (math.log(math.cos(p1) / math.cos(p2))
                      / math.log(math.tan(math.pi / 4 + p2 / 2)
                                 / math.tan(math.pi / 4 + p1 / 2)))
        else:
            self.n = math.sin(p1)
        self.F = (math.cos(p1) * math.tan(math.pi / 4 + p1 / 2) ** self.n
                  / self.n)
        self.lon0 = float(_wrap(float(nml["stand_lon"])))
        if "ref_x" in nml:
            self.i1, self.j1 = float(nml["ref_x"]), float(nml["ref_y"])
        else:
            self.i1, self.j1 = (self.nx + 1) / 2.0, (self.ny + 1) / 2.0
        self.X1, self.Y1 = self.to_plane(float(nml["ref_lat"]),
                                         float(nml["ref_lon"]))

    def rho(self, lat_deg):
        phi = np.radians(np.asarray(lat_deg, np.float64))
        return EARTH_RADIUS_M * self.F / np.tan(np.pi / 4 + phi / 2) ** self.n

    def to_plane(self, lat_deg, lon_deg):
        """(X, Y) in metres, the pole at the origin, +Y away from it."""
        theta = self.n * np.radians(_wrap(np.asarray(lon_deg) - self.lon0))
        r = self.rho(lat_deg)
        return r * np.sin(theta), -r * np.cos(theta)

    def latlon(self, i, j):
        """(lat, lon) in degrees of 1-based grid index (i, j)."""
        X = self.X1 + (np.asarray(i, np.float64) - self.i1) * self.dx
        Y = self.Y1 + (np.asarray(j, np.float64) - self.j1) * self.dx
        r = np.hypot(X, Y)
        theta = np.arctan2(X, -Y)
        lon = _wrap(self.lon0 + np.degrees(theta) / self.n)
        lat = np.degrees(2.0 * np.arctan(
            (EARTH_RADIUS_M * self.F / r) ** (1.0 / self.n)) - np.pi / 2)
        return lat, lon

    def cache_key(self, cache: str):
        """The key of the reference's cache ``cache`` of this grid:
        "bilinear" (the full-grid weights) a tuple, hashed with the mesh's
        cell count; "overlaps" (the conservative overlap count) a string.
        Both are the keys the harness has kept since its first version, so
        caches made then still hit."""
        if cache == "bilinear":
            return (self.ny, self.nx, self.n, self.F, self.lon0, self.i1,
                    self.j1, self.X1, self.Y1, self.dx)
        return (f"{self.ny}x{self.nx}:{self.n!r}:{self.X1!r}:{self.Y1!r}:"
                f"{self.dx!r}")

    # the staggers, 0-based (j, i)
    def mass(self, j, i):
        return self.latlon(np.asarray(i) + 1.0, np.asarray(j) + 1.0)

    def u(self, j, i):
        return self.latlon(np.asarray(i) + 0.5, np.asarray(j) + 1.0)

    def v(self, j, i):
        return self.latlon(np.asarray(i) + 1.0, np.asarray(j) + 0.5)

    def corner(self, j, i):
        return self.latlon(np.asarray(i) + 0.5, np.asarray(j) + 0.5)

    def mapfac(self, lat_deg):
        phi = np.radians(np.asarray(lat_deg, np.float64))
        return self.n * self.rho(lat_deg) / (EARTH_RADIUS_M * np.cos(phi))

    def rotation(self, j, i):
        """(cos alpha, sin alpha) at mass points (j, i)."""
        j = np.asarray(j)
        i = np.asarray(i)
        jlo = np.where(j == 0, 0, j - 1)
        jhi = np.where(j == self.ny - 1, self.ny - 1, j + 1)
        la0, lo0 = self.mass(jlo, i)
        la1, lo1 = self.mass(jhi, i)
        lat, _ = self.mass(j, i)
        dlon = np.asarray(lo1 - lo0)
        dlon = np.where(dlon > 180.0, dlon - 360.0, dlon)
        dlon = np.where(dlon < -180.0, dlon + 360.0, dlon)
        alpha = np.arctan2(-np.cos(np.radians(lat)) * np.radians(dlon),
                           np.radians(la1 - la0))
        return np.cos(alpha), np.sin(alpha)


def grid(nml: dict) -> Lambert:
    return Lambert(nml)
