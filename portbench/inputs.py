"""The benchmark's inputs: a fixed MPAS-like mesh, seeded smooth fields, and
the classic NetCDF (CDF-2) files the program reads.

- ``cached_mesh``: a global Voronoi mesh over jittered Fibonacci generators
  (scipy's SphericalVoronoi), every vertex joining three cells, as MPAS
  meshes do. It depends on the configuration alone, never on ``--seed``,
  and is kept under the checkout's cache directory, with the grid file
  made from it.
- ``make_fields``: per variable a random base, amplitude, wave numbers and
  phase drawn from ``--seed``, over a level ramp; categorical fields are
  land (1) north of the equator and water (2) south of it.
- ``write_cdf2``: a streaming writer of classic 64-bit-offset NetCDF
  files, big-endian, ``Time`` the record dimension, as MPAS's own streams
  write it. One variable is made and written at a time, so a 2.4-GB
  history file never sits in the process's own memory whole.
- ``memory_file``: an anonymous file in memory (``memfd_create``) that
  the program opens by path. The input pair of every run goes there and
  not to disk: in a forecast pipeline the hour's files were just written
  by the model and sit in the host's page cache, and a run that wrote
  2.4 GB to disk would wear out the host's disk over a check's runs.

Frozen here, so that the inputs do not move when the program's own
generators change.
"""

from __future__ import annotations

import os
import struct

import numpy as np

XTIME_STRLEN = 64


def memory_file(name: str) -> tuple:
    """``(fd, path)``: an anonymous file in memory, and the path by which
    code of this process opens it. Closing ``fd`` frees the file once no
    one else holds it open."""
    fd = os.memfd_create(name)
    return fd, f"/proc/self/fd/{fd}"


# ----------------------------------------------------------------- mesh ----

def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    z = 1.0 - (2.0 * i + 1.0) / n
    theta = 2.0 * np.pi * i / phi
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=-1)


def _cells_on_vertex(voc: np.ndarray, nvertices: int) -> np.ndarray:
    """(nvertices, 3) 0-based cells of each vertex, in ascending cell
    order, from the 0-based, -1 padded verticesOnCell."""
    ncells, me = voc.shape
    cells = np.repeat(np.arange(ncells, dtype=np.int64), me)
    verts = voc.reshape(-1).astype(np.int64)
    keep = verts >= 0
    cells, verts = cells[keep], verts[keep]
    order = np.argsort(verts, kind="stable")
    cells, verts = cells[order], verts[order]
    first = np.searchsorted(verts, np.arange(nvertices))
    rank = np.arange(len(verts)) - first[verts]
    out = np.full((nvertices, 3), -1, dtype=np.int32)
    sel = rank < 3
    out[verts[sel], rank[sel]] = cells[sel]
    return out


def voronoi_mesh(ncells: int, nsoil: int, seed: int) -> dict:
    """The mesh as the grid file holds it: lat/lon in radians (longitude
    in [0, 2 pi)), 0-based connectivity, terrain and soil depths."""
    from scipy.spatial import SphericalVoronoi

    pts = fibonacci_sphere(ncells)
    rng = np.random.default_rng(seed)
    pts = pts + 0.05 * rng.standard_normal(pts.shape) / np.sqrt(ncells)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    sv = SphericalVoronoi(pts, radius=1.0)
    sv.sort_vertices_of_regions()
    verts = sv.vertices / np.linalg.norm(sv.vertices, axis=1, keepdims=True)
    max_edges = max(len(r) for r in sv.regions)
    voc = np.full((ncells, max_edges), -1, dtype=np.int32)
    for c, region in enumerate(sv.regions):
        voc[c, :len(region)] = region
    cov = _cells_on_vertex(voc, len(verts))

    def latlon(xyz):
        lat = np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0))
        lon = np.mod(np.arctan2(xyz[:, 1], xyz[:, 0]), 2.0 * np.pi)
        return lat, lon

    lat_c, lon_c = latlon(pts)
    lat_v, lon_v = latlon(verts)
    rng = np.random.default_rng(seed + 1)
    ter = 500.0 + 300.0 * np.sin(lat_c * 3) + rng.normal(0, 10, ncells)
    zs = 0.05 + 0.2 * np.arange(nsoil, dtype=np.float64)
    return {"lat_cell": lat_c, "lon_cell": lon_c, "lat_vertex": lat_v,
            "lon_vertex": lon_v, "voc": voc, "cov": cov, "ter": ter,
            "zs": zs}


def cached_mesh(cache_dir: str, mesh_cfg: dict) -> dict:
    """The configuration's mesh, made once and kept in ``cache_dir``."""
    key = f"mesh_{mesh_cfg['ncells']}_{mesh_cfg['nsoil']}_{mesh_cfg['seed']}"
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    m = voronoi_mesh(mesh_cfg["ncells"], mesh_cfg["nsoil"], mesh_cfg["seed"])
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **m)
    os.replace(tmp, path)
    return m


def cached_grid_file(cache_dir: str, mesh_cfg: dict, mesh: dict) -> str:
    """The MPAS grid file of ``mesh``, written once into ``cache_dir``."""
    key = (f"grid_{mesh_cfg['ncells']}_{mesh_cfg['nz']}_{mesh_cfg['nsoil']}"
           f"_{mesh_cfg['seed']}.nc")
    path = os.path.join(cache_dir, key)
    if not os.path.exists(path):
        tmp = path + ".tmp"
        write_grid_file(tmp, mesh, mesh_cfg["nz"])
        os.replace(tmp, path)
    return path


# --------------------------------------------------------------- fields ----

def field_levels(varlists: dict, nz: int, nsoil: int) -> tuple:
    """({diag var: nlev or None}, {hist var: (nlev or None, location)})
    for every variable the varlists read; location is "cell",
    "vertex" or "category" (a land/water field)."""
    from .reference.routing import routing

    r = routing(varlists, True, True, True)
    diag = {}
    for name, _ in r["diag"]:
        three_d = (name.startswith("refl10cm") and "max" not in name
                   and "1km" not in name)
        diag[name] = nz if three_d else None
    hist = {}
    for name, _ in r["patch_2d"] + r["cons_2d"] + r["nstd_2d"]:
        hist[name] = (None, "cell")
    for name, _ in r["nstd_2d"]:
        hist[name] = (None, "category")
    for name, _ in r["nz_3d"]:
        hist[name] = (nz, "cell")
    for name, _ in r["nzp1_3d"]:
        hist[name] = (nz + 1, "cell")
    for name, _ in r["vert_3d"]:
        hist[name] = (nz, "vertex")
    for name, _ in r["soil"]:
        hist[name] = (nsoil, "cell")
    if r["do_u"]:
        hist[r["u_var"]] = (nz, "cell")
    if r["do_v"]:
        hist[r["v_var"]] = (nz, "cell")
    return diag, hist


class FieldSpec:
    """One seeded field: base + amp * (sin(k1 lat) cos(k2 lon + ph)
    [+ the level ramp 0..1]), in float32 as the files store it; ``loc``
    "category" is 1 north of the equator, 2 south."""

    def __init__(self, rng, nlev, loc):
        self.base, self.amp = rng.uniform(-50, 300), rng.uniform(0.5, 20)
        self.k1, self.k2 = rng.uniform(1, 4), rng.uniform(1, 4)
        self.ph = rng.uniform(0, 6)
        self.nlev, self.loc = nlev, loc

    def values(self, lat, lon):
        """The field at points (lat, lon), in radians."""
        f32 = np.float32
        if self.loc == "category":
            return np.where(lat > 0, 1.0, 2.0).astype(f32)
        f2 = (np.sin(self.k1 * lat) * np.cos(self.k2 * lon + self.ph)
              ).astype(f32)
        if self.nlev is None:
            return (self.base + self.amp * f2).astype(f32)
        lev = np.linspace(0, 1, self.nlev, dtype=f32)
        return (self.base + self.amp * (f2[:, None] + lev[None, :])
                ).astype(f32)


def make_fields(varlists: dict, nz: int, nsoil: int, seed: int) -> tuple:
    """({diag var: FieldSpec}, {hist var: FieldSpec}) drawn from ``seed``,
    the diag list first, then the history lists, as chip_smoke.py draws
    them."""
    rng = np.random.default_rng(seed)
    dl, hl = field_levels(varlists, nz, nsoil)
    diag = {n: FieldSpec(rng, nl, "cell") for n, nl in dl.items()}
    hist = {n: FieldSpec(rng, nl, loc) for n, (nl, loc) in hl.items()}
    return diag, hist


# ----------------------------------------------------------------- CDF-2 ---

NC_CHAR, NC_INT, NC_FLOAT, NC_DOUBLE = 2, 4, 5, 6
_TYPES = {"S1": (NC_CHAR, ">S1", 1), "i4": (NC_INT, ">i4", 4),
          "f4": (NC_FLOAT, ">f4", 4), "f8": (NC_DOUBLE, ">f8", 8)}


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _name(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">i", len(b)) + b + b"\0" * (_pad4(len(b)) - len(b))


def _attr(name: str, value) -> bytes:
    if isinstance(value, str):
        b = value.encode()
        return (_name(name) + struct.pack(">ii", NC_CHAR, len(b)) + b
                + b"\0" * (_pad4(len(b)) - len(b)))
    if isinstance(value, (int, np.integer)):
        return _name(name) + struct.pack(">iii", NC_INT, 1, int(value))
    return _name(name) + struct.pack(">iid", NC_DOUBLE, 1, float(value))


def _attrs(attrs: dict) -> bytes:
    if not attrs:
        return struct.pack(">ii", 0, 0)
    return (struct.pack(">ii", 0x0C, len(attrs))
            + b"".join(_attr(k, v) for k, v in attrs.items()))


def write_cdf2(path: str, dims: list, variables: list, attrs: dict) -> int:
    """Write a CDF-2 file. ``dims``: [(name, size or None for the record
    dimension)]; ``variables``: [(name, dims, dtype key, attrs, make)],
    ``make()`` returning the variable's data (one record for record
    variables), called once, in order, while the file is written.
    Returns the bytes written."""
    dim_ix = {n: k for k, (n, _) in enumerate(dims)}
    size = {n: (1 if s is None else s) for n, s in dims}
    rec = {n for n, s in dims if s is None}
    metas = []
    for name, vd, dt, vattrs, make in variables:
        n = int(np.prod([size[d] for d in vd])) if vd else 1
        vsize = _pad4(n * _TYPES[dt][2])
        metas.append([name, vd, dt, vattrs, make, vsize,
                      bool(vd) and vd[0] in rec])

    def header(begins):
        out = [b"CDF\x02", struct.pack(">i", 1 if rec else 0)]
        out.append(struct.pack(">ii", 0x0A, len(dims)) if dims
                   else struct.pack(">ii", 0, 0))
        for n, s in dims:
            out.append(_name(n) + struct.pack(">i", 0 if s is None else s))
        out.append(_attrs(attrs))
        out.append(struct.pack(">ii", 0x0B, len(metas)))
        for (name, vd, dt, vattrs, _, vsize, _), begin in zip(metas, begins):
            out.append(_name(name) + struct.pack(">i", len(vd))
                       + b"".join(struct.pack(">i", dim_ix[d]) for d in vd)
                       + _attrs(vattrs)
                       + struct.pack(">iiq", _TYPES[dt][0],
                                     min(vsize, 2**32 - 4), begin))
        return b"".join(out)

    hlen = len(header([0] * len(metas)))
    begins, off = [], hlen
    order = ([m for m in metas if not m[6]] + [m for m in metas if m[6]])
    start = {}
    for m in order:
        start[m[0]] = off
        off += m[5]
    begins = [start[m[0]] for m in metas]
    written = 0
    with open(path, "wb") as f:
        h = header(begins)
        f.write(h)
        written += len(h)
        for name, vd, dt, _, make, vsize, _ in order:
            a = np.ascontiguousarray(np.asarray(make()), dtype=_TYPES[dt][1])
            f.write(a.tobytes())
            pad = vsize - a.nbytes
            f.write(b"\0" * pad)
            written += a.nbytes + pad
            del a
    return written


def write_grid_file(path: str, mesh: dict, nz: int) -> int:
    """The MPAS grid file of ``mesh`` with ``nz`` levels."""
    ncells, me = mesh["voc"].shape
    nv = len(mesh["lat_vertex"])
    nsoil = len(mesh["zs"])
    dims = [("Time", None), ("nCells", ncells), ("nVertices", nv),
            ("nVertLevels", nz), ("nVertLevelsP1", nz + 1),
            ("maxEdges", me), ("nSoilLevels", max(nsoil, 1)), ("TWO", 2),
            ("vertexDegree", 3)]
    variables = [
        ("latCell", ("nCells",), "f8", {}, lambda: mesh["lat_cell"]),
        ("lonCell", ("nCells",), "f8", {}, lambda: mesh["lon_cell"]),
        ("latVertex", ("nVertices",), "f8", {}, lambda: mesh["lat_vertex"]),
        ("lonVertex", ("nVertices",), "f8", {}, lambda: mesh["lon_vertex"]),
        ("verticesOnCell", ("nCells", "maxEdges"), "i4", {},
         lambda: mesh["voc"] + 1),
        ("cellsOnVertex", ("nVertices", "vertexDegree"), "i4", {},
         lambda: mesh["cov"] + 1),
        ("zs", ("nCells", "nSoilLevels"), "f8", {},
         lambda: np.broadcast_to(mesh["zs"], (ncells, nsoil))),
        ("ter", ("nCells",), "f8", {}, lambda: mesh["ter"]),
    ]
    return write_cdf2(path, dims, variables, {})


def write_data_file(path: str, mesh: dict, nz: int, fields: dict,
                    attrs: dict, xtime: str) -> int:
    """An MPAS diag or history file of ``fields`` ({name: FieldSpec}),
    float32, with ``xtime`` its valid time."""
    ncells = len(mesh["lat_cell"])
    nv = len(mesh["lat_vertex"])
    nsoil = len(mesh["zs"])
    dims = [("Time", None), ("nCells", ncells), ("nVertices", nv),
            ("nVertLevels", nz), ("nVertLevelsP1", nz + 1),
            ("nSoilLevels", max(nsoil, 1)), ("StrLen", XTIME_STRLEN)]
    lev_dim = {nz: "nVertLevels", nz + 1: "nVertLevelsP1"}
    if nsoil not in lev_dim:
        lev_dim[nsoil] = "nSoilLevels"
    variables = []
    for name, spec in fields.items():
        loc = "nVertices" if spec.loc == "vertex" else "nCells"
        vd = ("Time", loc) + (() if spec.nlev is None
                              else (lev_dim[spec.nlev],))
        lat, lon = ((mesh["lat_vertex"], mesh["lon_vertex"])
                    if spec.loc == "vertex"
                    else (mesh["lat_cell"], mesh["lon_cell"]))
        variables.append((name, vd, "f4",
                          {"units": "si", "long_name": name + " field"},
                          lambda s=spec, la=lat, lo=lon: s.values(la, lo)))
    xt = (xtime + " " * XTIME_STRLEN)[:XTIME_STRLEN]
    variables.append(("xtime", ("Time", "StrLen"), "S1", {},
                      lambda: np.frombuffer(xt.encode(), dtype="S1")))
    return write_cdf2(path, dims, variables, attrs)


def file_attrs(cfg_inputs: dict, diag: bool) -> dict:
    """The global attributes of a diag (``diag``) or history file."""
    a = {"config_start_time": cfg_inputs["start_time"],
         "config_dt": float(cfg_inputs["config_dt"]),
         "config_lsm_scheme": cfg_inputs["lsm_scheme"],
         "config_microp_scheme": cfg_inputs["microp_scheme"],
         "config_convection_scheme": cfg_inputs["convection_scheme"]}
    if diag:
        a["output_interval"] = int(cfg_inputs["output_interval"])
    return a
