"""The WRF target grid of a lat-lon namelist (``target_grid_type =
'lat-lon'``), from its formulas.

The namelist's ``nx``/``ny`` count the staggered points: the mass grid is
``(nx - 1) x (ny - 1)``. Mass point ``(j, i)`` (0-based) is grid index
``(i + 1, j + 1)``, at lat = lat1 + (j' - j1) dlat, lon = lon1 + (i' - i1)
dlon for grid index (i', j'); the U stagger is half a point west, the V
stagger half a point south, the corners both.

- Global (no ``dx``/``dy``, ``is_regional = .false.``; MPASSIT's
  program_setup.F90:195-211): dlon = 360 / (nx - 1), dlat = 180 / (ny -
  1), the first mass point (i1 = j1 = 1) at (-90 + dlat/2, stand_lon +
  dlon/2). MPASSIT builds it periodic in i, with poles
  (ESMF_GridCreate1PeriDim, model_grid.F90:684-696): ``periodic``.
- Regional (``dx``/``dy`` in degrees): the known point (``ref_x``,
  ``ref_y``, 1-based; the mass grid's middle when both are absent) at
  (``ref_lat``, ``ref_lon``).

An index i' below 0.5, or at or past N + 0.5 with N = round(360 / dlon)
the points round the globe, is moved by N before the longitude is taken
(WPS's ijll_latlon, which MPASSIT's map utilities keep): on the global
grid the U points of columns 0 and nx, and the first and last corner
columns, fall on one longitude, stand_lon.

The map factor is 1 on every stagger. MPASSIT leaves it unset for this
projection (get_map_factor has no lat-lon branch); the program states 1
as its choice, and the reference takes the same value.

No rotation: MPASSIT turns winds to grid-relative and writes
SINALPHA/COSALPHA for Lambert only (write_data.F90:447-477).
"""

from __future__ import annotations

import numpy as np


class LatLon:
    rotates = False

    def __init__(self, nml: dict):
        self.nx = int(nml["nx"]) - 1           # mass points west-east
        self.ny = int(nml["ny"]) - 1
        self.periodic = not nml.get("is_regional", True)
        if self.periodic:
            if "dx" in nml or "dy" in nml:
                raise ValueError("a global lat-lon grid takes no dx/dy")
            self.dlon = 360.0 / self.nx
            self.dlat = 180.0 / self.ny
            self.i1 = self.j1 = 1.0
            self.lon1 = float(nml["stand_lon"]) + self.dlon / 2.0
            self.lat1 = -90.0 + self.dlat / 2.0
        else:
            self.dlon, self.dlat = float(nml["dx"]), float(nml["dy"])
            if "ref_x" in nml:
                self.i1, self.j1 = float(nml["ref_x"]), float(nml["ref_y"])
            else:
                self.i1, self.j1 = (self.nx + 1) / 2.0, (self.ny + 1) / 2.0
            self.lat1, self.lon1 = float(nml["ref_lat"]), float(nml["ref_lon"])
        #: the points round the globe
        self.span = int(round(360.0 / self.dlon))

    def latlon(self, i, j):
        """(lat, lon) in degrees of 1-based grid index (i, j)."""
        i = np.asarray(i, np.float64)
        j = np.asarray(j, np.float64)
        i = np.where(i < 0.5, i + self.span, i)
        i = np.where(i >= self.span + 0.5, i - self.span, i)
        lat = self.lat1 + (j - self.j1) * self.dlat
        lon = self.lon1 + (i - self.i1) * self.dlon
        return lat, lon

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
        return np.ones_like(np.asarray(lat_deg, np.float64))

    def cache_key(self, cache: str):
        """The key of the reference's cache ``cache`` of this grid (see
        ``reference/grid.py``)."""
        key = ("lat-lon", self.ny, self.nx, self.lat1, self.lon1, self.i1,
               self.j1, self.dlat, self.dlon, self.span)
        return key if cache == "bilinear" else repr(key)


def grid(nml: dict) -> LatLon:
    return LatLon(nml)
