"""WRF/UPP-compatible NetCDF output.

Clones the reference's output schema dim-for-dim and attr-for-attr
(``write_data.F90:173-997``) including its quirks:

- DY global attribute written with the DX value (write_data.F90:215-216);
- the misspelled ``POL_ELAT`` attribute alongside POLE_LAT/POLE_LON
  (write_data.F90:254);
- Z_C defined on bottom_top_stag but written with only bottom_top levels —
  the top interface stays at the netCDF fill value (write_data.F90:479,1415);
- WRF transforms (quirk Q7, write_data.F90:1339-1475): T = theta - 300
  (the reference's `< 10.0` guard is a Fortran CONTINUE no-op, so the
  subtraction is unconditional), MU == 0, P_TOP = min over the domain of
  0.8*P_HYD top level (seeded with the field max), PB = P_HYD, Z_C = vertical
  midpoints of zgrid, PHB = zgrid*9.81, PH == 0, P == 0;
- Times truncated to 19 chars; XTIME = (start - valid) minutes — note the
  operand order (quirk Q11, write_data.F90:1225-1228).

Field data is float32 in the file (NF90_FLOAT throughout the reference).
Each transform is one pass that rounds once to float32 (``_transform``),
in the input's own precision where that gives the same bits and in
float64 elsewhere; the float64 arrays the writer makes are counted as
``write.f64_bytes``.

Each call that hands the file data (``create_var`` with data,
``write_var``, ``write_var_slab``) is a ``write.store`` span (``_Stores``),
so the writer's time splits into its transforms and its stores; each block
the streaming writer's thread writes is a ``write.block`` span of that
thread.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
from datetime import datetime

import numpy as np

from ..constants import PROJ_LC
from ..spans import active, count, recording, span
from .nc4 import NetCDF4File

log = logging.getLogger("mpassit_tpu_torch")

DATESTRLEN = 19
NC_FILL_FLOAT = np.float32(9.96921e36)


@dataclasses.dataclass
class RegridResult:
    """Target-grid fields grouped like the reference's bundles.
    Each list entry: (out_name, data, units, description) with data (ny, nx)
    for 2-D and (ny, nx, nlev) for 3-D."""

    diag2d: list = dataclasses.field(default_factory=list)
    diag3d: list = dataclasses.field(default_factory=list)
    cons2d: list = dataclasses.field(default_factory=list)
    patch2d: list = dataclasses.field(default_factory=list)
    nstd2d: list = dataclasses.field(default_factory=list)
    soil: list = dataclasses.field(default_factory=list)
    nz3d: list = dataclasses.field(default_factory=list)
    nzp13d: list = dataclasses.field(default_factory=list)
    vert3d: list = dataclasses.field(default_factory=list)
    u: np.ndarray = None      # (ny, nx+1, nz)
    v: np.ndarray = None      # (ny+1, nx, nz)
    hgt: np.ndarray = None    # (ny, nx)
    zs: np.ndarray = None     # (nsoil,)
    nz: int = 0
    nzp1: int = 0
    nsoil: int = 0


def _parse_wrf_time(s: str) -> datetime:
    """substr-based parse of 'YYYY-MM-DD_hh:mm:ss' (write_data.F90:1212-1224)."""
    return datetime(int(s[0:4]), int(s[5:7]), int(s[8:10]),
                    int(s[11:13]), int(s[14:16]), int(s[17:19]))


#: the bytes of one row block of Z_C's float64 midpoints (``_z_c``)
_BLOCK_BYTES = 4 << 20


def _transform(category, block, out) -> None:
    """The file's float32 values of ``block`` (any part of one field) into
    ``out`` (float32, the same shape), each rounded once from the value
    the reference computes in float64 (quirk Q7):

    - "T": theta - 300. For float32 input the float32 difference is that
      value rounded once (300 is a float32, and a float64 result rounded
      to float32 is the float32 result for 53 >= 2 * 24 + 2), so no
      float64 pass; any other input subtracts in float64.
    - "PHB": zgrid * 9.81, always in float64: 9.81 is no float32.
    - anything else: the values, cast once.

    The ufuncs cast through their own small buffers, so no field-sized
    float64 array is made."""
    if category == "T":
        np.subtract(block, 300.0, out=out, dtype=(
            np.float32 if block.dtype == np.float32 else np.float64))
    elif category == "PHB":
        np.multiply(block, 9.81, out=out, dtype=np.float64)
    else:
        out[...] = block


def _t3(a, category=None, reuse=None):
    """(ny, nx[, nlev]) -> C file order (1, [nlev,] ny, nx): a float32
    array, in the memory order ``astype`` gives (the input's), holding the
    category's transform (``_transform``) of ``a``.

    ``reuse``: a dict holding the last array made, by shape and strides,
    filled again in place of a new one of the same layout. The file has
    consumed it by then (every file and stand-in writes or copies what a
    call hands it before the call returns), and fresh pages cost the host
    more system time than the copy into them."""
    a = np.asarray(a)
    a = a[None] if a.ndim == 2 else np.moveaxis(a, 2, 0)[None]
    out = np.empty_like(a, dtype=np.float32)
    if reuse is not None:
        key = (out.shape, out.strides)
        if key not in reuse:
            reuse.clear()
            reuse[key] = out
        out = reuse[key]
    _transform(category, a, out)
    return out


def _midpoints(lower, upper, out, scratch) -> None:
    """Z_C's float32 midpoints 0.5 * (lower + upper) into ``out``, summed
    in the float64 ``scratch`` (float32 could overflow or round twice) and
    rounded once."""
    np.add(upper, lower, out=scratch, dtype=np.float64)
    np.multiply(scratch, 0.5, out=out)


def _z_c(zgrid, zc) -> None:
    """Z_C's nz midpoint levels ``zc`` ((nz, ny, nx) float32) of ``zgrid``
    ((ny, nx, nz + 1)), in row blocks through one float64 scratch of
    ``_BLOCK_BYTES`` or one row."""
    nz, ny, nx = zc.shape
    rows = max(1, _BLOCK_BYTES // (nz * nx * 8))
    scratch = np.empty((nz, min(rows, ny), nx), np.float64)
    count("write.f64_bytes", scratch.nbytes)
    for r0 in range(0, ny, rows):
        r1 = min(r0 + rows, ny)
        z = np.moveaxis(zgrid[r0:r1], 2, 0)
        _midpoints(z[:-1], z[1:], zc[:, r0:r1], scratch[:, :r1 - r0])


def _p_top(top, field_max: float) -> float:
    """P_TOP: the least 0.8 * top-level value of those >= 10, seeded with
    the field's max (write_data.F90:1362-1372). Rounding is monotone, so
    the least float64 product is the product of the least value."""
    sel = top >= 10.0
    if sel.any():
        return min(field_max, float(np.float64(top[sel].min()) * 0.8))
    return field_max


class _Stores:
    """The file (or whatever stands in for ``NetCDF4File``), each call
    that carries data a ``write.store`` span; every other call passes
    through."""

    def __init__(self, f):
        self._file = f

    def __getattr__(self, name):
        return getattr(self._file, name)

    def create_var(self, name, dims, dtype, data=None):
        if data is None:
            return self._file.create_var(name, dims, dtype)
        with span("write.store"):
            return self._file.create_var(name, dims, dtype, data=data)

    def write_var(self, name, data):
        with span("write.store"):
            return self._file.write_var(name, data)

    def write_var_slab(self, name, data, starts):
        with span("write.store"):
            return self._file.write_var_slab(name, data, starts)


class _W:
    """def_var + attrs helper matching the reference's per-variable attrs."""

    def __init__(self, f: NetCDF4File):
        self.f = f

    def var(self, name, dims, data, units, desc, coords, stagger,
            memorder, fieldtype=104, dtype="f4"):
        # per-field min/max sanity log (write_data.F90:1283,1349);
        # data=None defines the variable empty (streaming fills it later)
        if data is not None and log.isEnabledFor(logging.DEBUG) \
                and np.asarray(data).size:
            log.debug(" %s %s %s", name, np.min(data), np.max(data))
        self.f.create_var(name, dims, dtype, data=data)
        self.f.set_attr("description", desc, var=name)
        self.f.set_attr("units", units, var=name)
        self.f.set_attr("MemoryOrder", memorder, var=name)
        if coords is not None:
            self.f.set_attr("coordinates", coords, var=name)
        self.f.set_attr("stagger", stagger, var=name)
        self.f.set_attr("FieldType", fieldtype, var=name)


D2 = ("Time", "south_north", "west_east")
D2U = ("Time", "south_north", "west_east_stag")
D2V = ("Time", "south_north_stag", "west_east")
D3 = ("Time", "bottom_top", "south_north", "west_east")
D3P = ("Time", "bottom_top_stag", "south_north", "west_east")
D3S = ("Time", "soil_layers_stag", "south_north", "west_east")
D3U = ("Time", "bottom_top", "south_north", "west_east_stag")
D3V = ("Time", "bottom_top", "south_north_stag", "west_east")


def _write_preamble(f, w, cfg, grid, data, nz, nzp1, nsoil, hgt,
                    zs) -> None:
    """Dims, global attrs, coordinate/static vars, Times/ITIMESTEP/XTIME
    (write_data.F90:173-561) — shared by the in-memory and streaming
    writers. ``hgt`` None defines HGT empty (the streaming path fills it
    when its strip arrives)."""
    nx, ny = grid.nx, grid.ny
    if True:
        # --- dims (write_data.F90:177-194) -------------------------------
        f.create_dim("Time", None)
        f.ensure_unlimited_size("Time", 1)
        f.create_dim("west_east", nx)
        f.create_dim("west_east_stag", nx + 1)
        f.create_dim("south_north", ny)
        f.create_dim("south_north_stag", ny + 1)
        f.create_dim("bottom_top", nz)
        f.create_dim("bottom_top_stag", nzp1)
        f.create_dim("soil_layers_stag", nsoil)
        f.create_dim("StrLen", DATESTRLEN)

        # --- global attrs (write_data.F90:197-308) -----------------------
        A = f.set_attr
        A("WEST-EAST_GRID_DIMENSION", nx + 1)
        A("SOUTH-NORTH_GRID_DIMENSION", ny + 1)
        A("BOTTOM-TOP_GRID_DIMENSION", nz + 1)
        A("SIMULATION_START_DATE", data.start_time)
        A("START_DATE", data.start_time)
        A("DX", float(cfg.dx))
        A("DY", float(cfg.dx))          # reference writes DX for DY
        A("DT", float(data.config_dt))
        A("SF_SURFACE_PHYSICS", data.lsm_scheme)
        A("MP_PHYSICS", data.mp_scheme)
        A("CU_PHYSICS", data.conv_scheme)
        A("CEN_LAT", float(cfg.ref_lat))
        A("CEN_LON", float(cfg.ref_lon))
        A("TRUELAT1", float(cfg.truelat1))
        A("TRUELAT2", float(cfg.truelat2))
        A("MOAD_CEN_LAT", float(cfg.ref_lat))
        A("STAND_LON", float(cfg.stand_lon))
        A("POLE_LAT", float(cfg.pole_lat))
        A("POLE_LON", float(cfg.pole_lon))
        A("POL_ELAT", float(cfg.pole_lat))   # reference typo preserved
        A("MAP_PROJ", int(cfg.proj_code))
        A("MAP_PROJ_CHAR", cfg.map_proj_char)
        if cfg.interp_diag:
            A("PREC_ACC_DT", int(data.diag_out_interval))
        A("I_PARENT_START", 1)
        A("J_PARENT_START", 1)
        A("WEST-EAST_PATCH_START_UNSTAG", 1)
        A("WEST-EAST_PATCH_START_STAG", 1)
        A("SOUTH-NORTH_PATCH_START_UNSTAG", 1)
        A("SOUTH-NORTH_PATCH_START_STAG", 1)
        A("BOTTOM-TOP_PATCH_START_UNSTAG", 1)
        A("BOTTOM-TOP_PATCH_START_STAG", 1)
        A("WEST-EAST_PATCH_END_UNSTAG", nx)
        A("WEST-EAST_PATCH_END_STAG", nx + 1)
        A("SOUTH-NORTH_PATCH_END_UNSTAG", ny)
        A("SOUTH-NORTH_PATCH_END_STAG", ny + 1)
        A("BOTTOM-TOP_PATCH_END_UNSTAG", nz)
        A("BOTTOM-TOP_PATCH_END_STAG", nz + 1)

        # --- coordinate / static vars (write_data.F90:312-561) -----------
        w.var("XLONG", D2, _t3(grid.lon), "degree_east",
              "LONGITUDE, WEST IS NEGATIVE", "XLONG XLAT", "", "XY ")
        w.var("XLONG_U", D2U, _t3(grid.lon_u), "degree_east",
              "LONGITUDE, WEST IS NEGATIVE", "XLONG_U XLAT_U", "X", "XY ")
        w.var("XLONG_V", D2V, _t3(grid.lon_v), "degree_east",
              "LONGITUDE, WEST IS NEGATIVE", "XLONG_V XLAT_V", "Y", "XY ")
        w.var("XLAT", D2, _t3(grid.lat), "degree_north",
              "LATITUDE, SOUTH IS NEGATIVE", "XLONG XLAT", "", "XY ")
        w.var("XLAT_U", D2U, _t3(grid.lat_u), "degree_north",
              "LATITUDE, SOUTH IS NEGATIVE", "XLONG_U XLAT_U", "X", "XY ")
        w.var("XLAT_V", D2V, _t3(grid.lat_v), "degree_north",
              "LATITUDE, SOUTH IS NEGATIVE", "XLONG_V XLAT_V", "Y", "XY ")
        # MAPFAC description/units quirks preserved (write_data.F90:402-445)
        w.var("MAPFAC_M", D2, _t3(grid.mapfac_m), "degree_north",
              "LATITUDE, SOUTH IS NEGATIVE", "XLONG XLAT", " ", "XY ")
        w.var("MAPFAC_U", D2U, _t3(grid.mapfac_u), "degree_north",
              "LATITUDE, SOUTH IS NEGATIVE", "XLONG_U XLAT_U", "X", "XY ")
        w.var("MAPFAC_V", D2V, _t3(grid.mapfac_v), "degree_north",
              "LATITUDE, SOUTH IS NEGATIVE", "XLONG_V XLAT_V", "Y", "XY ")
        if cfg.proj_code == PROJ_LC:
            w.var("SINALPHA", D2, _t3(grid.sina), " ",
                  "SINE OF GRID ROTATION ANGLE ALPHA", "XLONG XLAT", " ", "XY ")
            w.var("COSALPHA", D2, _t3(grid.cosa), " ",
                  "COSINE OF GRID ROTATION ANGLE ALPHA", "XLONG XLAT", " ", "XY ")

        # Z_C on the staggered vertical dim; written below only for the nz
        # midpoint levels (top interface stays at fill — see module docstring)
        zc_fill = np.full((1, nzp1, ny, nx), NC_FILL_FLOAT, dtype=np.float32)
        w.var("Z_C", D3P, zc_fill, "m AMSL",
              "Layer center height above mean sea level", "XLAT XLONG Z_C",
              "", "XYZ ")
        zsdat = np.zeros((1, nsoil), np.float32)
        if zs is not None:
            zsdat[0, :] = np.asarray(zs, dtype=np.float32)[:nsoil]
        w.var("ZS", ("Time", "soil_layers_stag"), zsdat, "m",
              "DEPTHS OF CENTERS OF SOIL LAYERS", "ZS XTIME", "", "X")
        # hgt None: define HGT empty — the streaming writer fills it when
        # the regridded terrain strip arrives
        w.var("HGT", D2, None if hgt is None else _t3(hgt), "m AMSL",
              "TERRAIN HEIGHT ", "XLAT XLONG ", "", "XY ")

        times = np.zeros((1, DATESTRLEN), dtype="S1")
        vt = (data.valid_time + " " * DATESTRLEN)[:DATESTRLEN]
        times[0] = np.frombuffer(vt.encode("ascii", "replace"), dtype="S1")
        f.create_var("Times", ("Time", "StrLen"), "S1", data=times)
        f.set_attr("description", "Times", var="Times")
        f.set_attr("units", "m", var="Times")
        f.set_attr("coordinates", "Time", var="Times")
        f.set_attr("stagger", "", var="Times")
        f.set_attr("FieldType", 104, var="Times")

        # XTIME = start - valid in minutes (quirk Q11 operand order)
        xtime_min = 0.0
        itimestep = 0
        if data.start_time and data.valid_time:
            delta = _parse_wrf_time(data.start_time) - _parse_wrf_time(data.valid_time)
            xtime_min = delta.total_seconds() / 60.0
            if data.config_dt > 0.0:
                itimestep = int(delta.total_seconds() / data.config_dt)
        f.create_var("ITIMESTEP", ("Time",), "i4",
                     data=np.array([itimestep], np.int32))
        f.set_attr("description", "", var="ITIMESTEP")
        f.set_attr("units", "", var="ITIMESTEP")
        f.set_attr("stagger", "", var="ITIMESTEP")
        f.set_attr("FieldType", 106, var="ITIMESTEP")
        f.set_attr("MemoryOrder", "O ", var="ITIMESTEP")
        f.create_var("XTIME", ("Time",), "f4",
                     data=np.array([xtime_min], np.float32))
        f.set_attr("description", "minutes since " + data.start_time, var="XTIME")
        f.set_attr("units", "minutes since " + data.start_time, var="XTIME")
        f.set_attr("stagger", "", var="XTIME")
        f.set_attr("FieldType", 104, var="XTIME")
        f.set_attr("MemoryOrder", "O ", var="XTIME")


class StreamingWriter:
    """Streamed write_to_file: the full output schema (dims, attrs, static
    vars, every field variable) is created up front, then regridded strips
    are written into the variables AS THEY ARE FETCHED from the device —
    the host never materializes the (ny, nx, 973) output (7.4 GB at full
    CONUS load), and a writer thread overlaps the HDF5 writes with the
    next strip's device fetch (VERDICT r3 item 2; the reference's
    equivalent is a full FieldGather + serial put_var per field,
    write_data.F90:1005-1475, with every field resident on rank 0).

    ``plan``: dict of per-category [(out_name, units, desc)] lists (3-D
    categories implicitly carry nz/nzp1/nsoil levels) plus "do_u"/"do_v"
    booleans — the same routing-derived lists the in-memory path fills
    into RegridResult, known before any apply runs.

    Usage: ``open()`` -> any number of ``put(var, lev0, block)`` (levels
    must arrive in ascending order per variable — the strip loops
    guarantee this) -> ``finish()``. Transforms (quirk Q7: T-300,
    PHB=zgrid*9.81 + Z_C midpoints, PB=P_HYD, P_TOP) run in the writer
    thread, level by level, through the in-memory path's functions;
    streamed and in-memory files are asserted identical in
    tests/test_torch_streaming.py."""

    _ZERO_NLEV = {"diag2d": None, "cons2d": None, "patch2d": None,
                  "nstd2d": None}

    def __init__(self, path, cfg, grid, data, plan, nz, nzp1, nsoil, zs,
                 queue_depth: int = 2):
        self.path, self.cfg, self.grid, self.data = path, cfg, grid, data
        self.plan = plan
        self.nz, self.nzp1, self.nsoil = nz, nzp1, nsoil
        self.zs = zs
        self._depth = queue_depth
        self.f = None
        self._vmeta = {}          # var -> (category, nlev)
        self._phb_prev = None     # (level_index, (ny, nx) plane)
        self._zc_scratch = None   # (ny, nx) float64, Z_C's midpoint sums
        self._phyd_max = -np.inf
        self._phyd_top = None
        self._minmax = {}
        self._q = None
        self._thread = None
        self._exc = None
        #: the recorder of the call that made the writer, for its thread
        self._timings = active()

    # -- schema -----------------------------------------------------------
    def open(self):
        import threading

        cfg, grid, data = self.cfg, self.grid, self.data
        nz, nzp1, nsoil = self.nz, self.nzp1, self.nsoil
        nx, ny = grid.nx, grid.ny
        wrf_mod = cfg.wrf_mod_vars
        plan = self.plan
        self.f = f = _Stores(NetCDF4File(self.path, "w"))
        w = _W(f)
        _write_preamble(f, w, cfg, grid, data, nz, nzp1, nsoil, None,
                        self.zs)
        self._vmeta["HGT"] = ("hgt", None)

        def define(entries, category, dims, nlev, memorder, stagger="",
                   coords="XLONG XLAT XTIME"):
            for name, units, desc in entries:
                w.var(name, dims, None, units, desc, coords, stagger,
                      memorder)
                self._vmeta[name] = (category, nlev)

        # schema order mirrors write_data.F90:567-994 / write_output below
        define(plan.get("diag2d", []) + plan.get("cons2d", [])
               + plan.get("patch2d", []) + plan.get("nstd2d", []),
               "2d", D2, None, "XY ")
        define(plan.get("diag3d", []), "3d", D3, nz, "XYZ ")
        define(plan.get("soil", []), "3d", D3S, nsoil, "XYZ ")
        for name, units, desc in plan.get("nz3d", []):
            w.var(name, D3, None, units, desc, "XLONG XLAT XTIME", "",
                  "XYZ ")
            self._vmeta[name] = ("T" if wrf_mod and name == "T" else "3d",
                                 nz)
            if wrf_mod and name == "MUB":
                w.var("MU", D3, np.zeros((1, nz, ny, nx), np.float32),
                      units, "Perturbation " + desc, "XLONG XLAT XTIME",
                      "", "XYZ ")
            if wrf_mod and name == "P_HYD":
                self._vmeta[name] = ("P_HYD", nz)
                f.create_var("P_TOP", ("Time",), "f4")
                f.set_attr("MemoryOrder", "0 ", var="P_TOP")
                f.set_attr("units", units, var="P_TOP")
                f.set_attr("description", "PRESSURE TOP OF THE MODEL",
                           var="P_TOP")
                f.set_attr("stagger", "", var="P_TOP")
                f.set_attr("FieldType", 104, var="P_TOP")
                w.var("PB", D3, None, "Pa", "BASE STATE PRESSURE (pfull)",
                      "XLONG XLAT XTIME", "", "XYZ ")
        if plan.get("do_u"):
            w.var("U", D3U, None, "m s^{-1}", "", "XLONG_U XLAT_U XTIME",
                  "X", "XYZ ")
            self._vmeta["U"] = ("3d", nz)
        if plan.get("do_v"):
            w.var("V", D3V, None, "m s^{-1}", "", "XLONG_V XLAT_V XTIME",
                  "Y", "XYZ ")
            self._vmeta["V"] = ("3d", nz)
        for name, units, desc in plan.get("nzp13d", []):
            if name == "PHB":
                self._vmeta[name] = ("PHB", nzp1)
                if wrf_mod:
                    w.var(name, D3P, None, "gpm", "Base Geopotential "
                          "Height", "XLONG XLAT XTIME", "Z", "XYZ ")
                    w.var("PH", D3P,
                          np.zeros((1, nzp1, ny, nx), np.float32), "gpm",
                          "Perturbation Geopotential Height",
                          "XLONG XLAT XTIME", "Z", "XYZ ")
                    continue
            else:
                self._vmeta[name] = ("3d", nzp1)
            w.var(name, D3P, None, units, desc, "XLONG XLAT XTIME", "Z",
                  "XYZ ")
        for name, units, desc in plan.get("vert3d", []):
            w.var(name, D3, None, units, desc, "XLONG XLAT XTIME", "",
                  "XYZ")
            self._vmeta[name] = ("3d", nz)
        if wrf_mod:
            w.var("P", D3, np.zeros((1, nz, ny, nx), np.float32), "Pa",
                  "perturbation pressure (0.0)", "XLONG XLAT XTIME", "",
                  "XYZ ")
            if not f.has_var("PB"):
                w.var("PB", D3,
                      np.full((1, nz, ny, nx), NC_FILL_FLOAT, np.float32),
                      "Pa", "BASE STATE PRESSURE (pfull)",
                      "XLONG XLAT XTIME", "", "XYZ ")
        self._q = queue.Queue(maxsize=self._depth)
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()
        return self

    # -- streaming --------------------------------------------------------
    def _put_checked(self, item):
        """Bounded put that re-checks writer-thread health: if the thread
        died (e.g. disk full) while the queue was full, a plain blocking
        put would hang forever instead of raising (ADVICE r4 #2)."""
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                self._q.put(item, timeout=0.5)
            except queue.Full:
                continue
            # the thread may have died after the check above and dropped
            # this item: raise now rather than at the next put. It can
            # still die after this check; ``finish`` re-raises its error
            # after the join, so a dropped block always surfaces there
            if self._exc is not None:
                raise self._exc
            return

    def put(self, var, lev0, block):
        """Enqueue levels [lev0, lev0+k) of ``var`` (block (ny, nx[, k]));
        blocks for one var must arrive in ascending level order."""
        self._put_checked((var, lev0, block))

    def _drain(self):
        try:
            with recording(self._timings):
                while True:
                    item = self._q.get()
                    if item is None:
                        return
                    with span("write.block"):
                        self._write_block(*item)
        except BaseException as e:          # surfaced by put()/finish()
            self._exc = e
            # unblock any producer waiting on the bounded queue; items are
            # dropped — the run is failing and put() raises on next check
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    return

    def _track(self, var, arr):
        if log.isEnabledFor(logging.DEBUG) and arr.size:
            lo, hi = self._minmax.get(var, (np.inf, -np.inf))
            self._minmax[var] = (min(lo, float(np.min(arr))),
                                 max(hi, float(np.max(arr))))

    def _write_block(self, var, lev0, block):
        """Level-by-level: at production strip widths a whole-block
        transform copies a 256-level strip of 1801x1061 planes at once and
        contends with the fetch path for CPU; per level the working set is
        a few (ny, nx) planes, and the output is the same bits (every
        transform is elementwise per level)."""
        block = np.asarray(block)
        if block.ndim == 2:
            block = block[:, :, None]
        for kk in range(block.shape[2]):
            self._write_level(var, lev0 + kk, block[:, :, kk])

    def _write_level(self, var, lev, plane):
        f = self.f
        category, nlev = self._vmeta[var]
        dat = _t3(plane, category)[None]
        if category == "P_HYD":
            if lev == self.nz - 1:          # top level
                self._phyd_top = plane.copy()
            self._phyd_max = max(self._phyd_max, float(plane.max()))
            self._track("PB", dat)
            f.write_var_slab("PB", dat, (0, lev, 0, 0))
        elif category == "PHB":
            # Z_C midpoint against the previous interface level (levels
            # arrive in ascending order per variable); only the nz
            # midpoint levels are written (top interface stays at fill,
            # module docstring)
            prev = self._phb_prev
            if prev is not None and prev[0] == lev - 1 and lev - 1 < self.nz:
                if self._zc_scratch is None:
                    self._zc_scratch = np.empty(plane.shape, np.float64)
                    count("write.f64_bytes", self._zc_scratch.nbytes)
                zc = np.empty((1, 1) + plane.shape, np.float32)
                _midpoints(prev[1], plane, zc[0, 0], self._zc_scratch)
                f.write_var_slab("Z_C", zc, (0, lev - 1, 0, 0))
            self._phb_prev = (lev, plane.copy())
        self._track(var, dat)
        if nlev is None:
            f.write_var_slab(var, dat[:, 0], (0, 0, 0))
        else:
            f.write_var_slab(var, dat, (0, lev, 0, 0))

    def finish(self):
        """Drain the queue, write the deferred P_TOP, flush the min/max
        debug log, close the file. The file is closed whether or not
        this raises."""
        try:
            self._put_checked(None)
            self._thread.join()
            if self._exc is not None:
                raise self._exc
            if self.f.has_var("P_TOP") and self._phyd_top is not None:
                ptop = _p_top(self._phyd_top, self._phyd_max)
                self.f.write_var("P_TOP", np.array([ptop], np.float32))
            for var, (lo, hi) in self._minmax.items():
                log.debug(" %s %s %s", var, lo, hi)
        finally:
            if self.f is not None:
                self.f.close()
                self.f = None


class NullStreamWriter:
    """Streaming-writer stand-in for NON-PRIMARY processes of a multi-host
    run (VERDICT r4 item 3): every process executes the identical SPMD
    streamed program — participating in each strip's fetch collective —
    but only process 0 holds the real StreamingWriter and the file (the
    reference's rank-0 serial write, write_data.F90:1005-1475); the others
    drop their strips here. Peak non-root host memory is one fetched strip
    plus the buffered wind mass fields, same budget as process 0."""

    def put(self, var, lev0, block):
        pass

    def finish(self):
        pass


def write_output(path: str, cfg, grid, data, res: RegridResult) -> None:
    """write_to_file equivalent (write_data.F90:20-1498).

    cfg: Config; grid: TargetGrid; data: mpas_reader.InputData.
    """
    nx, ny = grid.nx, grid.ny
    nz, nzp1, nsoil = res.nz, res.nzp1, res.nsoil
    wrf_mod = cfg.wrf_mod_vars
    reuse = {}                  # the fields' file arrays (``_t3``)

    with NetCDF4File(path, "w") as nc:
        f = _Stores(nc)
        w = _W(f)
        _write_preamble(
            f, w, cfg, grid, data, nz, nzp1, nsoil,
            res.hgt if res.hgt is not None else np.zeros((ny, nx)), res.zs)

        # --- 2-D fields: diag, cons, patch, nstd (write order of
        #     write_data.F90:567-731, 1247-1264) --------------------------
        for name, arr, units, desc in (res.diag2d + res.cons2d +
                                       res.patch2d + res.nstd2d):
            w.var(name, D2, _t3(arr, None, reuse), units, desc,
                  "XLONG XLAT XTIME", "", "XY ")

        # --- 3-D diag fields ---------------------------------------------
        for name, arr, units, desc in res.diag3d:
            w.var(name, D3, _t3(arr, None, reuse), units, desc,
                  "XLONG XLAT XTIME", "", "XYZ ")

        # --- soil fields -------------------------------------------------
        for name, arr, units, desc in res.soil:
            w.var(name, D3S, _t3(arr, None, reuse), units, desc,
                  "XLONG XLAT XTIME", "", "XYZ ")

        # --- 3-D nz hist fields + WRF extras ------------------------------
        for name, arr, units, desc in res.nz3d:
            # theta - 300 (the reference's `<10` guard is a no-op CONTINUE)
            out = _t3(arr, "T" if wrf_mod and name == "T" else None, reuse)
            w.var(name, D3, out, units, desc, "XLONG XLAT XTIME", "", "XYZ ")
            if wrf_mod and name == "MUB":
                w.var("MU", D3, np.zeros((1, nz, ny, nx), np.float32), units,
                      "Perturbation " + desc, "XLONG XLAT XTIME", "", "XYZ ")
            if wrf_mod and name == "P_HYD":
                arr = np.asarray(arr)
                ptop = _p_top(arr[:, :, nz - 1], float(arr.max()))
                f.create_var("P_TOP", ("Time",), "f4",
                             data=np.array([ptop], np.float32))
                f.set_attr("MemoryOrder", "0 ", var="P_TOP")
                f.set_attr("units", units, var="P_TOP")
                f.set_attr("description", "PRESSURE TOP OF THE MODEL", var="P_TOP")
                f.set_attr("stagger", "", var="P_TOP")
                f.set_attr("FieldType", 104, var="P_TOP")
                # PB = P_HYD: the same float32 array
                w.var("PB", D3, out, "Pa", "BASE STATE PRESSURE (pfull)",
                      "XLONG XLAT XTIME", "", "XYZ ")

        # --- staggered winds (write_data.F90:832-866, 1160-1197) ---------
        if res.u is not None:
            w.var("U", D3U, _t3(res.u, None, reuse), "m s^{-1}", "",
                  "XLONG_U XLAT_U XTIME", "X", "XYZ ")
        if res.v is not None:
            w.var("V", D3V, _t3(res.v, None, reuse), "m s^{-1}", "",
                  "XLONG_V XLAT_V XTIME", "Y", "XYZ ")

        # --- 3-D nzp1 hist fields + Z_C/PHB/PH transforms ----------------
        for name, arr, units, desc in res.nzp13d:
            if name == "PHB":
                # Z_C = vertical midpoints (write_data.F90:1406-1416)
                zc = np.asarray(f._f["Z_C"][...])
                _z_c(np.asarray(arr), zc[0, :nz])
                f.write_var("Z_C", zc)
            out = _t3(arr, "PHB" if name == "PHB" else None, reuse)
            if wrf_mod and name == "PHB":
                w.var(name, D3P, out, "gpm", "Base Geopotential Height",
                      "XLONG XLAT XTIME", "Z", "XYZ ")
                w.var("PH", D3P, np.zeros((1, nzp1, ny, nx), np.float32),
                      "gpm", "Perturbation Geopotential Height",
                      "XLONG XLAT XTIME", "Z", "XYZ ")
            else:
                w.var(name, D3P, out, units, desc,
                      "XLONG XLAT XTIME", "Z", "XYZ ")

        # --- 3-D vertex hist fields --------------------------------------
        for name, arr, units, desc in res.vert3d:
            w.var(name, D3, _t3(arr, None, reuse), units, desc,
                  "XLONG XLAT XTIME", "", "XYZ")

        # --- dummy P (and PB if no P_HYD produced it) ---------------------
        if wrf_mod:
            w.var("P", D3, np.zeros((1, nz, ny, nx), np.float32), "Pa",
                  "perturbation pressure (0.0)", "XLONG XLAT XTIME", "", "XYZ ")
            if not f.has_var("PB"):
                w.var("PB", D3,
                      np.full((1, nz, ny, nx), NC_FILL_FLOAT, np.float32),
                      "Pa", "BASE STATE PRESSURE (pfull)",
                      "XLONG XLAT XTIME", "", "XYZ ")
