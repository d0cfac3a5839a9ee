"""Variable lists and interpolation-method routing.

Replaces the reference's varlist parsing (``read_varlist``,
input_data.F90:1146-1194) and its hardcoded routing of history variables to
regrid methods (input_data.F90:840-966):

- 2-D hist: ``snow``/``snowh`` -> conservative; ``ivgtyp``/``isltyp``/
  ``xland``/``landmask`` -> nearest; everything else -> "patch" (which is
  BILINEAR — quirk Q1, interp.F90:204).
- 3-D hist: ``zgrid``/``w`` -> nzp1 levels; ``vorticity`` -> vertex
  (node-located); ``uReconstructZonal``/``uReconstructMeridional`` -> the
  staggered-wind path when wrf_mod_vars (input_data.F90:898-903); everything
  else -> nz levels.
- soil list -> soil category (regridded nearest by quirk Q3).
"""

from __future__ import annotations

import dataclasses
import os

CONS_VARS = ("snow", "snowh")                                  # input_data.F90:840
NSTD_VARS = ("ivgtyp", "isltyp", "xland", "landmask")          # input_data.F90:841
NZP1_VARS = ("zgrid", "w")                                     # input_data.F90:842
VERT_VARS = ("vorticity",)                                     # input_data.F90:843
U_VAR = "uReconstructZonal"
V_VAR = "uReconstructMeridional"


@dataclasses.dataclass
class FieldSpec:
    in_name: str
    out_name: str
    units: str = ""
    long_name: str = ""


@dataclasses.dataclass
class Routing:
    """Per-category (bundle) field lists, preserving varlist order."""

    diag: list = dataclasses.field(default_factory=list)
    patch_2d: list = dataclasses.field(default_factory=list)
    cons_2d: list = dataclasses.field(default_factory=list)
    nstd_2d: list = dataclasses.field(default_factory=list)
    nz_3d: list = dataclasses.field(default_factory=list)
    nzp1_3d: list = dataclasses.field(default_factory=list)
    vert_3d: list = dataclasses.field(default_factory=list)
    soil: list = dataclasses.field(default_factory=list)
    do_u: bool = False
    do_v: bool = False

    def soil_method(self) -> str:
        """Quirk Q3 (interp.F90:436-447): the soil bundle reuses whatever
        `method` was last assigned — NEAREST_STOD if any nstd fields exist,
        else CONSERVE if any cons fields, else BILINEAR."""
        if self.nstd_2d:
            return "nearest"
        if self.cons_2d:
            return "conserve"
        return "bilinear"


def read_varlist(path: str) -> list[FieldSpec]:
    """Two whitespace-separated columns: mpas_name OUTPUT_NAME
    (input_data.F90:1146-1194; blank lines skipped)."""
    from ..errors import FatalError

    if not os.path.exists(path):
        # input_data.F90:1162: error_handler("VARLIST FILE <f> not exist", 1)
        raise FatalError(f"VARLIST FILE {path} not exist", rc=1)
    specs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2:
                # input_data.F90:1189: error_handler("READING VARLIST FILE")
                raise FatalError(f"READING VARLIST FILE: bad line {line!r}")
            specs.append(FieldSpec(in_name=parts[0], out_name=parts[1]))
    return specs


def build_routing(varlist_dir: str, interp_diag: bool, interp_hist: bool,
                  wrf_mod_vars: bool) -> Routing:
    """init_input_hist_fields routing (input_data.F90:858-966) +
    init_input_diag_fields (input_data.F90:266-310)."""
    r = Routing()
    if interp_diag:
        r.diag = read_varlist(os.path.join(varlist_dir, "diaglist"))
    if interp_hist:
        h2d = read_varlist(os.path.join(varlist_dir, "histlist_2d"))
        h3d = read_varlist(os.path.join(varlist_dir, "histlist_3d"))
        r.soil = read_varlist(os.path.join(varlist_dir, "histlist_soil"))
        for s in h2d:
            if s.in_name in CONS_VARS:
                r.cons_2d.append(s)
            elif s.in_name in NSTD_VARS:
                r.nstd_2d.append(s)
            else:
                r.patch_2d.append(s)
        for s in h3d:
            if wrf_mod_vars and s.in_name == U_VAR:
                r.do_u = True
            elif wrf_mod_vars and s.in_name == V_VAR:
                r.do_v = True
            elif s.in_name in NZP1_VARS:
                r.nzp1_3d.append(s)
            elif s.in_name in VERT_VARS:
                r.vert_3d.append(s)
            else:
                r.nz_3d.append(s)
    return r
