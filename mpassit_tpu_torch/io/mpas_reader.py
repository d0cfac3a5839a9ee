"""MPAS diag/history file reading.

Replaces ``input_data.F90``'s data reads (read_input_diag_data :123-264,
read_input_hist_data :316-812): whole variables are read on the host (the
reference reads the FULL array on every rank too) plus the global attributes
used for the output file (scheme codes, start time, dt, xtime).

Data layout: MPAS files store (Time, nCells[, nVertLevels]) in C order; we
return (ncells,) / (ncells, nz) float64 arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..errors import NetCDFError, netcdf_guard
from ..fields.registry import FieldSpec, Routing, U_VAR, V_VAR
from .nc4 import open_dataset

# global-attribute scheme-name -> WRF integer code maps
# (input_data.F90:346-384)
LSM_CODES = {"noah": 2, "ruc": 3}
MP_CODES = {"mp_thompson": 8, "mp_nssl2m": 18}
CONV_CODES = {"cu_ntiedke": 16, "cu_kain_fritsch": 1, "cu_grell_freitas": 3}


@dataclasses.dataclass
class InputData:
    """Everything read from the diag/hist files, keyed by input name."""

    fields: dict = dataclasses.field(default_factory=dict)   # name -> ndarray
    units: dict = dataclasses.field(default_factory=dict)
    long_name: dict = dataclasses.field(default_factory=dict)
    start_time: str = ""
    valid_time: str = ""
    config_dt: float = 0.0
    lsm_scheme: int = 0
    mp_scheme: int = 0
    conv_scheme: int = 0
    diag_out_interval: int = 0
    u: np.ndarray = None   # (ncells, nz) uReconstructZonal
    v: np.ndarray = None


def _open(path: str):
    """nf90_open with the reference's error context
    (input_data.F90:146,340: netcdf_err 'opening: <file>')."""
    with netcdf_guard(f"opening: {path}"):
        return open_dataset(path)


def _read_field(f, name: str, dtype=np.float32):
    # input_data.F90:184: netcdf_err 'reading field id - <vname>' when the
    # varlist entry is absent from the file
    if not f.has_var(name):
        raise NetCDFError(f"reading field id - {name}",
                          "NetCDF: Variable not found")
    with netcdf_guard(f"reading field - {name}"):
        # default f32: the apply engines compute in f32 and the output file
        # is f32 either way, so f64 ingest only doubled host residency
        # (~17 GB at 2.6M cells x 55 levels). compute_dtype='float64' (the
        # reference's -r8, CMakeLists.txt:80) restores f64 end to end.
        a = np.asarray(f.read_var(name), dtype=dtype)
        if a.ndim >= 1 and f.var_dims(name) and f.var_dims(name)[0] == "Time":
            a = a[0]
        return a


def _xtime(f) -> str:
    # input_data.F90:255: netcdf_err 'reading xtime id'
    if not f.has_var("xtime"):
        raise NetCDFError("reading xtime id", "NetCDF: Variable not found")
    raw = np.asarray(f.read_var("xtime"))
    if raw.ndim == 2:
        raw = raw[0]
    if raw.dtype.kind in ("S", "U"):
        s = b"".join(x if isinstance(x, bytes) else x.encode()
                     for x in raw.reshape(-1))
        return s.decode("utf-8", "replace").rstrip("\x00").rstrip()
    return str(raw)


def read_diag_data(path: str, routing: Routing, data: InputData,
                   interp_hist: bool, dtype=np.float32) -> None:
    """read_input_diag_data (input_data.F90:123-264)."""
    with _open(path) as f:
        for spec in routing.diag:
            a = _read_field(f, spec.in_name, dtype)
            data.fields[spec.in_name] = a
            attrs = f.var_attrs(spec.in_name)
            data.units[spec.in_name] = attrs.get("units", "")
            data.long_name[spec.in_name] = attrs.get("long_name", "")
        st = f.get_attr("config_start_time", None)
        if st is None and not interp_hist:
            # input_data.F90:227: netcdf_err 'reading config_start_time'
            raise NetCDFError("reading config_start_time",
                              "NetCDF: Attribute not found")
        if st is not None:
            data.start_time = str(st).rstrip("\x00")
        dt = f.get_attr("config_dt", None)
        data.config_dt = float(dt) if dt is not None else 0.0
        oi = f.get_attr("output_interval", None)
        try:
            data.diag_out_interval = int(float(oi)) if oi is not None else 0
        except (TypeError, ValueError):
            data.diag_out_interval = 0
        data.valid_time = _xtime(f)


def read_hist_data(path: str, routing: Routing, data: InputData,
                   dtype=np.float32) -> None:
    """read_input_hist_data (input_data.F90:316-812)."""
    with _open(path) as f:
        att = f.get_attr("config_lsm_scheme", None)
        data.lsm_scheme = LSM_CODES.get(str(att).strip(), 0) if att else 0
        att = f.get_attr("config_microp_scheme", None)
        data.mp_scheme = MP_CODES.get(str(att).strip(), 0) if att else 0
        att = f.get_attr("config_convection_scheme", None)
        data.conv_scheme = CONV_CODES.get(str(att).strip(), 0) if att else 0
        # start time is REQUIRED from the hist file (input_data.F90:357-359)
        with netcdf_guard("reading config_start_time"):
            data.start_time = str(f.get_attr("config_start_time")).rstrip("\x00")
        dt = f.get_attr("config_dt", None)
        if dt is not None:
            data.config_dt = float(dt)
        data.valid_time = _xtime(f)

        cats = (routing.patch_2d + routing.cons_2d + routing.nstd_2d +
                routing.soil + routing.nz_3d + routing.nzp1_3d +
                routing.vert_3d)
        for spec in cats:
            a = _read_field(f, spec.in_name, dtype)
            data.fields[spec.in_name] = a
            attrs = f.var_attrs(spec.in_name)
            data.units[spec.in_name] = attrs.get("units", "")
            data.long_name[spec.in_name] = attrs.get("long_name", "")
        if routing.do_u:
            data.u = _read_field(f, U_VAR, dtype)
        if routing.do_v:
            data.v = _read_field(f, V_VAR, dtype)
