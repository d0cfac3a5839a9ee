"""The work one hour has to do, counted from the configuration, not from
how the program does it.

- ``apply_bytes``: for each regrid the source columns read once, the
  weights once (4 bytes of index and 4 of weight per nonzero: 3 a mapped
  point for cell and vertex bilinear, 1 for nearest, 4 for the U/V
  restagger, the overlaps the reference counts for conservative) and the
  outputs written once; on a grid that rotates, the 10-m wind rotation
  reads u, v, cos and sin and writes u and v. The restagger maps the
  points inside the mass grid: on a regional grid every U point but the
  two outermost columns and every V point but the two outermost rows; on
  a periodic grid every U point, the seam's two columns one and the same
  (4 ny nx), and besides the inner V rows each pole's row, whose points
  take one value, the mean of the nx mass points next to the pole (nx
  nonzeros a pole; ``reference/expected.py``).
- ``fetch_bytes``: what the hour has to bring to the host, the output
  variables that are regridded: target points x output columns x 4. The
  mass winds feed the restagger and are no output.
"""

from __future__ import annotations

from .reference.routing import routing, soil_method

F32 = 4
NNZ_BYTES = 8


def columns(cfg: dict) -> dict:
    """Output columns by method; the mass winds apart."""
    nml = cfg["namelist"]
    nz, nsoil = cfg["mesh"]["nz"], cfg["mesh"]["nsoil"]
    r = routing(cfg["varlists"], nml.get("interp_diag", True),
                nml.get("interp_hist", True),
                bool(nml.get("wrf_mod_vars", False)))
    cols = {"bilinear": 1, "nearest": 0, "conserve": 0, "vertex": 0}
    for n, _ in r["diag"]:
        three_d = (n.startswith("refl10cm") and "max" not in n
                   and "1km" not in n)
        cols["bilinear"] += nz if three_d else 1
    cols["bilinear"] += len(r["patch_2d"]) + nz * len(r["nz_3d"]) \
        + (nz + 1) * len(r["nzp1_3d"])
    cols["nearest"] += len(r["nstd_2d"])
    cols["conserve"] += len(r["cons_2d"])
    cols[soil_method(r)] += nsoil * len(r["soil"])
    cols["vertex"] += nz * len(r["vert_3d"])
    winds = nz * (int(r["do_u"]) + int(r["do_v"]))
    diag = dict(r["diag"])
    return {"cols": cols, "mass_winds": winds, "do_u": r["do_u"],
            "do_v": r["do_v"], "nz": nz,
            "rotate10": "u10" in diag and "v10" in diag}


def apply_bytes(cfg: dict, grid, ncells: int, nvertices: int,
                conserve_nnz: int) -> int:
    """The bytes of ``cfg``'s hour on the reference's target ``grid``
    (``reference/grid.py``)."""
    c = columns(cfg)
    ny, nx = grid.ny, grid.nx
    T = ny * nx
    nnz = {"bilinear": 3 * T, "nearest": T, "conserve": conserve_nnz,
           "vertex": 3 * T}
    src = {"bilinear": ncells, "nearest": ncells, "conserve": ncells,
           "vertex": nvertices}
    total = 0
    for m, k in c["cols"].items():
        k += c["mass_winds"] if m == "bilinear" else 0
        if k:
            total += (src[m] + T) * k * F32 + nnz[m] * NNZ_BYTES
    nz = c["nz"]
    if c["do_u"]:
        tu = ny * (nx + 1)
        u_nnz = 4 * ny * (nx if grid.periodic else nx - 1)
        total += (T + tu) * nz * F32 + u_nnz * NNZ_BYTES
    if c["do_v"]:
        tv = (ny + 1) * nx
        v_nnz = 4 * (ny - 1) * nx + (2 * nx if grid.periodic else 0)
        total += (T + tv) * nz * F32 + v_nnz * NNZ_BYTES
    if c["rotate10"] and grid.rotates:
        total += 6 * T * F32
    return total


def fetch_bytes(cfg: dict, ny: int, nx: int) -> int:
    c = columns(cfg)
    n = sum(c["cols"].values()) * ny * nx
    if c["do_u"]:
        n += ny * (nx + 1) * c["nz"]
    if c["do_v"]:
        n += (ny + 1) * nx * c["nz"]
    return n * F32
