"""Run configuration: Fortran-namelist-compatible parser + derivation rules.

Replaces the reference's ``program_setup.F90``: the ``&config`` namelist
(``program_setup.F90:103-106``), its defaults (``:108-117``), the projection
dispatch (``:169-192``), the global/regional lat-lon derivation (``:195-229``),
the ``truelat2`` default (``:232-235``) and the center-of-domain reference
point default (``:238-244``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

from .constants import (
    EARTH_RADIUS_M,
    NAN,
    PI,
    PROJ_LATLON,
    PROJ_LC,
    PROJ_MERC,
    PROJ_PS,
)


from .errors import FatalError


class ConfigError(FatalError):
    """Raised for invalid configuration (the reference error_handler
    prints + mpi_aborts, program_setup.F90 via utils.F90:16-33)."""


# ---------------------------------------------------------------------------
# Fortran namelist parsing (a small, standard-conforming subset: one or more
# groups, `key = value` pairs, `!` comments, quoted strings, logicals,
# numbers including Fortran double-precision exponents like 1.d0).
# ---------------------------------------------------------------------------

_LOGICAL_RE = re.compile(r"^\.?(t(rue)?|f(alse)?)\.?$", re.IGNORECASE)
_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([edED][+-]?\d+)?$")


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if _LOGICAL_RE.match(tok):
        return tok.lstrip(".").lower().startswith("t")
    if _INT_RE.match(tok):
        return int(tok)
    if _FLOAT_RE.match(tok):
        return float(tok.lower().replace("d", "e"))
    # bare string (nonstandard but tolerated)
    return tok


def _strip_comment(line: str) -> str:
    out = []
    in_q: str | None = None
    for ch in line:
        if in_q:
            out.append(ch)
            if ch == in_q:
                in_q = None
            continue
        if ch in "'\"":
            in_q = ch
            out.append(ch)
        elif ch == "!":
            break
        else:
            out.append(ch)
    return "".join(out)


def parse_namelist(text: str) -> dict[str, dict[str, Any]]:
    """Parse Fortran namelist text into {group: {key: value}} (keys lowercased)."""
    groups: dict[str, dict[str, Any]] = {}
    current: dict[str, Any] | None = None
    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if line.startswith("&"):
            name = line[1:].split()[0].lower()
            current = groups.setdefault(name, {})
            line = line[1 + len(name):].strip()
            if not line:
                continue
        if line in ("/", "&end", "$end"):
            current = None
            continue
        if current is None:
            continue
        if line.endswith("/"):
            line = line[:-1].strip()
            close = True
        else:
            close = False
        # split on commas that separate key=value pairs, and on '=' per pair
        for pair in re.finditer(r"([A-Za-z_]\w*(?:\(\d+\))?)\s*=\s*([^=]*?)(?=(?:,?\s*[A-Za-z_]\w*(?:\(\d+\))?\s*=)|$)", line):
            key = pair.group(1).lower()
            val = pair.group(2).strip().rstrip(",").strip()
            if "," in val and not (val and val[0] in "'\""):
                current[key] = [_parse_value(v) for v in val.split(",") if v.strip()]
            else:
                current[key] = _parse_value(val)
        if close:
            current = None
    return groups


def read_namelist_file(path: str) -> dict[str, dict[str, Any]]:
    with open(path) as f:
        return parse_namelist(f.read())


# ---------------------------------------------------------------------------
# Config dataclass
# ---------------------------------------------------------------------------

_PROJ_BY_NAME = {
    "LAMBERT": (PROJ_LC, "Lambert Conformal"),
    "MERCATOR": (PROJ_MERC, "Mercator"),
    "POLAR": (PROJ_PS, "Polar Stereographic"),
    "LAT-LON": (PROJ_LATLON, "Lat/Lon"),
}


def _is_nan(x: float) -> bool:
    return x == NAN


@dataclasses.dataclass
class Config:
    """Mirrors program_setup.F90 module variables (namelist + derived)."""

    # --- namelist variables (program_setup.F90:23-76) -----------------------
    grid_file_input_grid: str = "NULL"
    diag_file_input_grid: str = "NULL"
    hist_file_input_grid: str = "NULL"
    file_target_grid: str = "NULL"
    output_file: str = "NULL"
    interp_diag: bool = False
    interp_hist: bool = False
    wrf_mod_vars: bool = False
    esmf_log: bool = False
    target_grid_type: str = ""
    block_decomp_file: str = "NULL"
    is_regional: bool = True
    nx: int = 0
    ny: int = 0
    truelat1: float = NAN
    truelat2: float = NAN
    stand_lon: float = NAN
    dx: float = NAN
    dy: float = NAN
    ref_lat: float = NAN
    ref_lon: float = NAN
    ref_x: float = NAN
    ref_y: float = NAN
    pole_lat: float = 90.0
    pole_lon: float = 0.0
    interp_as_bundle: bool = True

    # --- extensions beyond the reference ------------------------------------
    #: directory holding diaglist/histlist_* (reference reads from CWD,
    #: input_data.F90:1160); default "." preserves that behavior.
    varlist_dir: str = "."
    #: on-disk weight cache directory ("" disables) — the RegridStore analog.
    weights_cache_dir: str = ""
    #: shard the apply over this many local JAX devices (0/1 = single device;
    #: -1 = all). Replaces the reference's MPI rank count (mpassit.F90:14-15).
    n_device_shards: int = 0
    #: apply numerics. Default "split6_bf16": the SAME six compensated
    #: bf16 product terms XLA's Precision.HIGHEST computes in six MXU
    #: passes, stacked along the contraction dim into ONE pass — ~1e-7
    #: rel err (parity-grade; the reference computes f64 but writes f32,
    #: CMakeLists.txt:80, so 1e-7 is at the file format's own rounding)
    #: at the full speed of the fused kernel (measured within 5% of
    #: split_bf16 on v5e; Precision.HIGHEST was 29% slower). "highest"
    #: (f32 operands, Precision.HIGHEST) is the strict reference
    #: implementation split6 is validated against; "split_bf16" (~1e-5,
    #: three stacked terms) trades accuracy for nothing at CONUS W=16 —
    #: both stacks pad to the MXU's 128 contraction depth — but wins when
    #: W is large (6W > 128 costs extra passes, e.g. production 2.6M-cell
    #: meshes at W=80).
    apply_precision: str = "split6_bf16"
    #: source-field placement across devices (the reference's route-handle
    #: halo exchange, interp.F90:123-134): "replicate" keeps the source on
    #: every device (zero collectives on the hot path), "allgather" shards
    #: it and assembles the halo with one all_gather inside shard_map,
    #: "ring" rotates source blocks with ppermute (peak memory = one block
    #: per device — the multi-host / huge-mesh configuration). Only
    #: meaningful with n_device_shards != 0.
    source_decomp: str = "replicate"
    #: apply arithmetic: "float32" (default — the file output is f32
    #: either way, matching WRF) or "float64" (the reference's -r8 compute,
    #: CMakeLists.txt:80; rides the gather engines instead of the MXU
    #: slab-matmul).
    compute_dtype: str = "float32"
    #: gather terminal fields to process 0 only (the reference's
    #: ESMF_FieldGather rootPet=0 pattern, write_data.F90:1006): non-root
    #: processes skip the host copy of writer-bound fields, cutting their
    #: peak host memory. Default off = gather-to-all (every process holds
    #: every field — simplest SPMD). Wind mass fields always gather-to-all
    #: (they feed the sharded restagger).
    fetch_root_only: bool = False
    #: stream regridded strips straight into the output NetCDF as they are
    #: fetched from the device (a writer thread overlaps the HDF5 writes
    #: with the next strip's fetch): peak host memory drops from the full
    #: (ny, nx, n_cols) output (7.4 GB at the production CONUS load) to
    #: one strip plus the wind mass fields, and the separate write_to_file
    #: walk disappears. Single-process only (the serial rank-0 writer);
    #: the in-memory path remains the default for the library API (whose
    #: PipelineArtifacts.result carries the arrays).
    stream_output: bool = False
    #: cell renumbering for HBM gather coherence — the locality analog of
    #: the reference's METIS block_decomp_file (model_grid.F90:2367-2426):
    #: "morton" (default) orders source cells along a Z-curve over the
    #: target grid's index space so each 32x32 target tile's slab gather
    #: reads a compact span of source rows; "none" keeps file order.
    cell_order: str = "morton"

    # --- derived (program_setup.F90:60-71) ----------------------------------
    dxkm: float = NAN
    dykm: float = NAN
    dlondeg: float = NAN
    dlatdeg: float = NAN
    known_lat: float = NAN
    known_lon: float = NAN
    known_x: float = NAN
    known_y: float = NAN
    i_target: int = 0
    j_target: int = 0
    proj_code: int = -1
    map_proj_char: str = ""

    @classmethod
    def from_namelist(cls, path: str, check_files: bool = True) -> "Config":
        groups = read_namelist_file(path)
        if "config" not in groups:
            raise ConfigError(f"no &config group in {path}")
        return cls.from_dict(groups["config"], check_files=check_files)

    @classmethod
    def from_dict(cls, nml: dict[str, Any], check_files: bool = True) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in nml.items() if k in known}
        cfg = cls(**kwargs)
        cfg.finalize(check_files=check_files)
        return cfg

    # program_setup.F90:145-245
    def finalize(self, check_files: bool = True) -> None:
        if self.source_decomp not in ("replicate", "allgather", "ring"):
            raise ConfigError(
                'source_decomp must be "replicate", "allgather", or "ring"')
        if self.cell_order not in ("morton", "none"):
            raise ConfigError('cell_order must be "morton" or "none"')
        if self.compute_dtype not in ("float32", "float64"):
            raise ConfigError(
                'compute_dtype must be "float32" or "float64"')
        if check_files and self.block_decomp_file != "NULL":
            if not os.path.exists(self.block_decomp_file):
                raise ConfigError("block_decomp_file DOES NOT EXIST.")

        if self.target_grid_type.strip() == "file":
            return

        self.dxkm = self.dx
        self.dykm = self.dy
        self.known_lat = self.ref_lat
        self.known_lon = self.ref_lon
        self.known_x = self.ref_x
        self.known_y = self.ref_y
        # Reference semantics: namelist nx/ny are the *staggered* dims; the
        # mass grid is one smaller (program_setup.F90:163-164).
        self.i_target = self.nx - 1
        self.j_target = self.ny - 1

        key = self.target_grid_type.strip().upper()
        if key not in _PROJ_BY_NAME:
            raise ConfigError(
                "In namelist, invalid target_grid_type specified. Valid "
                'projections are "lambert", "mercator", "polar", and "lat-lon".'
            )
        self.proj_code, self.map_proj_char = _PROJ_BY_NAME[key]

        if self.proj_code == PROJ_LATLON:
            if _is_nan(self.dx) and _is_nan(self.dy):
                # global grid (program_setup.F90:196-210, quirk Q9)
                if self.is_regional:
                    raise ConfigError(
                        "For lat-lon projection, if dx/dy are not specified a "
                        "global grid is assumed; set dx/dy or is_regional=.false."
                    )
                self.dlondeg = 360.0 / self.i_target
                self.dlatdeg = 180.0 / self.j_target
                self.known_x = 1.0
                self.known_y = 1.0
                self.known_lon = self.stand_lon + self.dlondeg / 2.0
                self.known_lat = -90.0 + self.dlatdeg / 2.0
                self.dxkm = EARTH_RADIUS_M * PI * 2.0 / self.i_target
                self.dykm = EARTH_RADIUS_M * PI / self.j_target
            else:
                # regional grid (program_setup.F90:213-228)
                if not self.is_regional:
                    raise ConfigError(
                        "For lat-lon projection, if dx/dy are specified a "
                        "regional grid is assumed; unset dx/dy or is_regional=.true."
                    )
                self.dlatdeg = self.dy
                self.dlondeg = self.dx
                self.dxkm = self.dlondeg * EARTH_RADIUS_M * PI * 2.0 / 360.0
                self.dykm = self.dlatdeg * EARTH_RADIUS_M * PI * 2.0 / 360.0
                if _is_nan(self.known_lat) or _is_nan(self.known_lon):
                    raise ConfigError(
                        "For lat-lon projection with dx/dy specified, "
                        "ref_lat/ref_lon must also be specified"
                    )

        # truelat2 <- truelat1 default for Lambert (program_setup.F90:232-235)
        if self.proj_code == PROJ_LC and _is_nan(self.truelat2):
            if _is_nan(self.truelat1):
                raise ConfigError(
                    "No TRUELAT1 specified for Lambert conformal projection."
                )
            self.truelat2 = self.truelat1

        # Default reference point = domain center (program_setup.F90:238-244)
        if _is_nan(self.known_x) and _is_nan(self.known_y):
            self.known_x = (self.i_target + 1) / 2.0
            self.known_y = (self.j_target + 1) / 2.0
        elif _is_nan(self.known_x) or _is_nan(self.known_y):
            raise ConfigError(
                "In namelist, neither or both of ref_x, ref_y must be specified."
            )
