"""Which regrid method each listed variable takes, as MPASSIT routes them
(input_data.F90:840-966, interp.F90:204-447).

- diag list: bilinear;
- 2-D history list: ``snow``/``snowh`` conservative; ``ivgtyp``/
  ``isltyp``/``xland``/``landmask`` nearest source-to-destination;
  everything else bilinear (MPASSIT's "patch" bundle is bilinear);
- 3-D history list: ``zgrid``/``w`` on nz+1 levels; ``vorticity`` at
  vertices; ``uReconstructZonal``/``uReconstructMeridional`` the
  staggered winds (with ``wrf_mod_vars``); the rest on nz levels;
- soil list: the method assigned last before it (nearest when any nearest
  field exists, else conservative when any conservative one does, else
  bilinear).

Variables are ``(mpas name, output name)`` pairs, in list order.
"""

from __future__ import annotations

CONS = ("snow", "snowh")
NSTD = ("ivgtyp", "isltyp", "xland", "landmask")
NZP1 = ("zgrid", "w")
VERT = ("vorticity",)
U_VAR = "uReconstructZonal"
V_VAR = "uReconstructMeridional"


def routing(varlists: dict, interp_diag: bool, interp_hist: bool,
            wrf_mod_vars: bool) -> dict:
    r = {"diag": [], "patch_2d": [], "cons_2d": [], "nstd_2d": [],
         "nz_3d": [], "nzp1_3d": [], "vert_3d": [], "soil": [],
         "do_u": False, "do_v": False, "u_var": U_VAR, "v_var": V_VAR}
    pairs = {k: [tuple(p) for p in v] for k, v in varlists.items()}
    if interp_diag:
        r["diag"] = pairs["diaglist"]
    if interp_hist:
        r["soil"] = pairs["histlist_soil"]
        for p in pairs["histlist_2d"]:
            key = ("cons_2d" if p[0] in CONS else
                   "nstd_2d" if p[0] in NSTD else "patch_2d")
            r[key].append(p)
        for p in pairs["histlist_3d"]:
            if wrf_mod_vars and p[0] == U_VAR:
                r["do_u"] = True
            elif wrf_mod_vars and p[0] == V_VAR:
                r["do_v"] = True
            elif p[0] in NZP1:
                r["nzp1_3d"].append(p)
            elif p[0] in VERT:
                r["vert_3d"].append(p)
            else:
                r["nz_3d"].append(p)
    return r


def soil_method(r: dict) -> str:
    if r["nstd_2d"]:
        return "nearest"
    if r["cons_2d"]:
        return "conserve"
    return "bilinear"
