#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mpassit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--ncells N]

Run from the root of a checkout. It needs a CUDA device and exits 1
without one; it imports nothing of JAX or of the JAX package's
device-bound modules. Phases, each printing one JSON line:

- device: the card (name and power limit from nvidia-smi), torch and CUDA
  versions, whether h5py and ninja are importable;
- build: compiles the five sources of mpassit_tpu_torch/csrc/ with nvcc,
  one process each, started together;
- inputs: a synthetic global MPAS mesh of 655,362 cells (the size of
  MPAS's x1.655362 30-km mesh), nz=55, nsoil=4, with seeded smooth fields
  for every variable of the shipped parm/ varlists, written as NetCDF4
  (or as CDF-2 through scipy when h5py is missing);
- main_path, main_path_onehot, main_path_gather: the CLI function
  ``mpassit_tpu_torch.run.pipeline.main`` on the shipped
  parm/namelist.input target (Lambert CONUS 3 km), its file paths pointed
  at the inputs and a weights cache under .bench_cache/, once per apply
  route: the default, MPASSIT_ELL_KERNEL=0 (one-hot kernels) and
  MPASSIT_GATHER_KERNEL=1 (in-kernel gather; the later runs find the
  weights cache warm). Every kernel's launch and plain-call counters are
  zeroed just before each run and read just after, against the launches
  the route owes for the applies it made; stage timings and peak device
  memory per run;
- check (per route): sampled target points of every output variable
  against a float64 numpy evaluation sum(w * src[idx]) of the same ELL
  weights (after an f64 Q4 rotation for the winds), bound 1e-6 of the
  variable's largest sampled magnitude; the gather route's result must
  equal the default route's bit for bit, the one-hot route's within 1e-6
  of each variable's largest magnitude;
- kernel_vs_plain: each kernel against its plain PyTorch version on the
  card, at the main path's shapes: the packed bilinear+nearest+conserve
  pack of this mesh and grid at Cp=1024 with the (0, 55, 55) rotate window
  (with and without checksum) and the EDGE1 restagger pack (W ~ 1096,
  Cp=128); the one-hot kernels for each precision; the gather kernel also
  bit for bit against packed_apply; the ELL-built split_bf16 variants v1
  and v2 (CC 128 and 256) on the bilinear operator at 512 columns, within
  1e-6 of max|plain| and v1 within 1e-6 of v2; median times by CUDA events
  after a warm-up;
- write_wall: the store-only kernel at the packed output shape (Cp=1024)
  bit for bit against its plain version over the whole output, its write
  GB/s, and packed_apply's time as a multiple of it (the measured write
  roofline of the apply);
- kernel_variants: the tool mpassit_tpu_torch.tools.kernel_variants
  (v0 = packed_apply, v1, v2 at CC 128 and 256, the write wall at 512
  columns) on this mesh's cached bilinear operator at the full target
  width, with its spot checks (v1 vs v2 within 1e-6, v1 vs v0 within 3e-5
  of max|v0|).

The counters of every kernel are zeroed just before each phase that drives
a path (the three main-path routes, write_wall, kernel_variants) and read
just after; the kernels line takes each kernel's launches from the phase
that runs it.

Then the kernels line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed phase exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".bench_cache", "chip_smoke")
NCELLS = 655_362          # MPAS x1.655362 (30-km quasi-uniform) cell count
NZ, NSOIL = 55, 4
TOL_REL = 1e-6            # f32 apply vs f64 oracle (register R10 class)
TOL_KERNEL = 1e-6         # kernel vs plain, relative to max|plain|


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def importable(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


# --------------------------------------------------------------- inputs ----

def _fields(routing, mesh, rng, np):
    """Seeded smooth fields for every variable the routing reads: per
    variable a random base, amplitude and wave numbers over a level
    ramp."""
    from mpassit_tpu.fields.registry import U_VAR, V_VAR

    lat = np.deg2rad(mesh.lat_cell)
    lon = np.deg2rad(mesh.lon_cell)
    latv = np.deg2rad(mesh.lat_vertex)
    lonv = np.deg2rad(mesh.lon_vertex)

    def field(nlev, vertex=False):
        base, amp = rng.uniform(-50, 300), rng.uniform(0.5, 20)
        k1, k2, ph = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(0, 6)
        la, lo = (latv, lonv) if vertex else (lat, lon)

        def make():
            f2 = (np.sin(k1 * la) * np.cos(k2 * lo + ph)).astype(np.float32)
            if nlev is None:
                return base + amp * f2
            lev = np.linspace(0, 1, nlev, dtype=np.float32)
            return base + amp * (f2[:, None] + lev[None, :])
        return make

    diag, hist = {}, {}
    for s in routing.diag:
        diag[s.in_name] = field(NZ if s.in_name.startswith("refl10cm")
                                and "max" not in s.in_name
                                and "1km" not in s.in_name else None)
    for s in routing.patch_2d + routing.cons_2d + routing.nstd_2d:
        hist[s.in_name] = field(None)
    for s in routing.nstd_2d:        # categorical, like xland
        hist[s.in_name] = (lambda la=lat: np.where(la > 0, 1.0, 2.0)
                           .astype(np.float32))
    for s in routing.nz_3d:
        hist[s.in_name] = field(NZ)
    for s in routing.nzp1_3d:
        hist[s.in_name] = field(NZ + 1)
    for s in routing.vert_3d:
        hist[s.in_name] = field(NZ, vertex=True)
    for s in routing.soil:
        hist[s.in_name] = field(NSOIL)
    if routing.do_u:
        hist[U_VAR] = field(NZ)
    if routing.do_v:
        hist[V_VAR] = field(NZ)
    return diag, hist


def prepare_inputs(work, parm, ncells, seed, classic):
    """Mesh, grid/diag/hist files and the namelist under ``work``; returns
    the namelist path and what was written."""
    import numpy as np

    from mpassit_tpu.fields.registry import build_routing
    from mpassit_tpu.mesh.synthetic import synthetic_voronoi_mesh

    if classic:
        from mpassit_tpu_torch.testing import (
            write_data_file_classic as write_data,
            write_grid_file_classic as write_grid,
        )
    else:
        from mpassit_tpu.mesh.synthetic import (
            write_mpas_data_file as write_data,
            write_mpas_grid_file as write_grid,
        )
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    mesh = synthetic_voronoi_mesh(ncells=ncells, nz=NZ, nsoil=NSOIL,
                                  seed=seed + 1)
    t_mesh = time.perf_counter() - t0
    routing = build_routing(parm, True, True, True)
    diag, hist = _fields(routing, mesh, np.random.default_rng(seed), np)
    attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 20.0,
             "config_lsm_scheme": "noah",
             "config_microp_scheme": "mp_thompson",
             "config_convection_scheme": "cu_ntiedke"}
    paths = {k: os.path.join(work, k + ".nc") for k in ("grid", "diag",
                                                        "hist")}
    write_grid(mesh, paths["grid"])
    write_data(mesh, paths["diag"], diag,
               attrs={**attrs, "output_interval": 60},
               xtime="2024-03-25_10:00:00", dtype="f4")
    write_data(mesh, paths["hist"], hist, attrs=attrs,
               xtime="2024-03-25_10:00:00", dtype="f4")
    # the shipped namelist, its four file paths pointed at this run's files
    nml_lines = []
    repl = {"grid_file_input_grid": paths["grid"],
            "hist_file_input_grid": paths["hist"],
            "diag_file_input_grid": paths["diag"],
            "output_file": os.path.join(work, "mpassit_out.nc")}
    with open(os.path.join(parm, "namelist.input")) as f:
        for line in f:
            key = line.split("=")[0].strip().lower()
            if key in repl:
                line = f' {key} = "{repl[key]}"\n'
            elif line.strip() == "/":
                line = (f' varlist_dir = "{parm}"\n'
                        f' weights_cache_dir = "{os.path.join(work, "weights")}"'
                        "\n/\n")
            nml_lines.append(line)
    nml = os.path.join(work, "namelist.input")
    with open(nml, "w") as f:
        f.writelines(nml_lines)
    in_bytes = sum(os.path.getsize(p) for p in paths.values())
    return nml, {"ncells": mesh.ncells, "nvertices": mesh.nvertices,
                 "nz": NZ, "nsoil": NSOIL, "seed": seed,
                 "format": "CDF-2 (scipy)" if classic else "NetCDF4 (h5py)",
                 "input_bytes": in_bytes, "t_mesh_s": t_mesh,
                 "namelist": "".join(nml_lines)}


# ---------------------------------------------------------------- check ----

def check_outputs(art, n_sample, seed):
    """Sampled target points of every RegridResult variable against a
    float64 numpy evaluation of the same ELL weights. Returns
    {var: max rel err} and raises on any variable over TOL_REL."""
    import numpy as np

    from mpassit_tpu.constants import PROJ_LC
    from mpassit_tpu_torch.run.pipeline import build_weights

    cfg, grid, mesh, routing = art.cfg, art.grid, art.mesh, art.routing
    data, res = art.data, art.result
    W = build_weights(cfg, mesh, grid, routing)      # weight-cache hits
    rng = np.random.default_rng(seed)

    def sample(n_pts):
        return np.sort(rng.choice(n_pts, size=min(n_sample, n_pts),
                                  replace=False))

    def ell64(key, pts, src):
        e = W[key]
        s = np.asarray(src, np.float64)
        s = s[:, None] if s.ndim == 1 else s
        idx = np.asarray(e.idx)[pts]
        return np.einsum("pk,pkc->pc", np.asarray(e.w, np.float64)[pts],
                         s[idx])

    def rot64(u, v, pts_or_all):
        ca = np.asarray(grid.cosa, np.float64).reshape(-1)[pts_or_all]
        sa = np.asarray(grid.sina, np.float64).reshape(-1)[pts_or_all]
        ca, sa = ca[:, None], sa[:, None]
        tana = sa / ca
        un = (u + v * tana) / (ca + sa * tana)
        return un, (v - un * sa) / ca

    errs = {}

    def record(name, got, ref):
        scale = max(float(np.abs(ref).max()), 1e-30)
        errs[name] = float(np.abs(np.asarray(got, np.float64) - ref).max()
                           / scale)

    pts = sample(grid.n_points)
    lc = cfg.proj_code == PROJ_LC
    d2 = [s for s in routing.diag if data.fields[s.in_name].ndim == 1]
    d3 = [s for s in routing.diag if data.fields[s.in_name].ndim == 2]
    cats = [("diag2d", d2, "bilinear"), ("diag3d", d3, "bilinear"),
            ("patch2d", routing.patch_2d, "bilinear"),
            ("nz3d", routing.nz_3d, "bilinear"),
            ("nzp13d", routing.nzp1_3d, "bilinear"),
            ("cons2d", routing.cons_2d, "conserve"),
            ("nstd2d", routing.nstd_2d, "nearest"),
            ("soil", routing.soil, routing.soil_method()),
            ("vert3d", routing.vert_3d, "vertex")]
    names2 = [s.in_name for s in d2]
    rot10 = lc and "u10" in names2 and "v10" in names2
    for cat, specs, key in cats:
        entries = getattr(res, cat) or []
        if [e[0] for e in entries] != [s.out_name for s in specs]:
            raise AssertionError(f"{cat}: result names differ from routing")
        for (name, arr, *_), s in zip(entries, specs):
            got = np.asarray(arr).reshape(grid.n_points, -1)[pts]
            ref = ell64(key, pts, data.fields[s.in_name])
            if cat == "diag2d" and rot10 and s.in_name in ("u10", "v10"):
                u = ell64(key, pts, data.fields["u10"])
                v = ell64(key, pts, data.fields["v10"])
                ref = rot64(u, v, pts)[s.in_name == "v10"]
            record(name, got, ref)
    record("HGT", np.asarray(res.hgt).reshape(-1, 1)[pts],
           ell64("bilinear", pts, mesh.ter))
    # staggered winds: bilinear mesh -> mass points, f64 Q4 rotation,
    # then the EDGE1/EDGE2 restagger, evaluated at sampled stagger points
    for name, key, arr in (("U", "edge1", res.u), ("V", "edge2", res.v)):
        if arr is None:
            continue
        e = W[key]
        sp = sample(e.idx.shape[0])
        need = np.unique(np.asarray(e.idx)[sp])
        u = ell64("bilinear", need, data.u)
        v = ell64("bilinear", need, data.v)
        if lc:
            u, v = rot64(u, v, need)
        mass = np.zeros((grid.n_points, u.shape[1]))
        mass[need] = u if name == "U" else v
        ref = ell64(key, sp, mass)
        record(name, np.asarray(arr).reshape(-1, arr.shape[-1])[sp], ref)
    bad = {k: v for k, v in errs.items() if not v <= TOL_REL}
    if bad:
        raise AssertionError(f"f64 check over {TOL_REL}: {bad}")
    return errs


# ------------------------------------------------------- kernel vs plain ----

def _time_ms(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    ts.sort()
    return ts[len(ts) // 2]


def kernel_vs_plain(art, device, seed):
    """Every kernel against its plain PyTorch version on the card at the
    main path's shapes. Returns (per-case results, {kernel: summary});
    the summary's ms/plain_ms are those of the kernel's first case."""
    import numpy as np
    import torch

    from mpassit_tpu_torch.ops import gather_kernel as gk
    from mpassit_tpu_torch.ops import onehot_kernel as ok
    from mpassit_tpu_torch.ops import packed_kernel as pk
    from mpassit_tpu_torch.ops import variant_kernels as vk
    from mpassit_tpu_torch.ops.matmul_apply import (
        CH,
        PackedSlabRegridder,
        SlabMatmulRegridder,
    )
    from mpassit_tpu_torch.run.pipeline import build_weights

    cfg, grid = art.cfg, art.grid
    W = build_weights(cfg, art.mesh, grid, art.routing)
    rng = np.random.default_rng(seed)
    nz = art.mesh.nz
    cases = []

    def run_case(kernel, name, call, plain, checksum, extra=None):
        got = call()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        out = {"kernel": kernel, "case": name, "checksum": checksum}
        if checksum:
            (got, gcs), (ref, rcs) = got, ref
            out["checksum_max_rel_err"] = float(
                ((gcs.double() - rcs.double()).abs()
                 / rcs.double().abs().clamp_min(1e-30)).max())
        d = (got - ref).abs()
        scale = float(ref.abs().max())
        out.update(shape=list(got.shape), max_abs_err=float(d.max()),
                   max_abs_plain=scale,
                   max_rel_err=float(d.max()) / max(scale, 1e-30),
                   finite=bool(torch.isfinite(got).all()))
        if extra is not None:
            out.update(extra(got))
        del got, ref, d
        if not checksum:
            out["ms"] = _time_ms(torch, call, 10)
            out["plain_ms"] = _time_ms(torch, plain, 5)
            if out["ms"] > out["plain_ms"]:
                out["note"] = "kernel slower than plain"
        torch.cuda.empty_cache()
        ok_ = (out["finite"] and out["max_rel_err"] <= TOL_KERNEL
               and out.get("checksum_max_rel_err", 0.0) <= 1e-5
               and out.get("equal_to_packed_apply", True)
               and out.get("vs_v2_ok", True))
        out["ok"] = ok_
        cases.append(out)
        emit({"phase": "kernel_vs_plain", **out})
        if not ok_:
            raise AssertionError(f"kernel disagrees with plain: {out}")

    def operands(rg, C):
        src = torch.from_numpy(rng.standard_normal(
            (rg.n_src, C)).astype(np.float32)).to(device)
        slab = torch.index_select(src, 0, rg.slab_idx).view(
            rg.n_tiles, rg.W, C)
        src_pad = torch.nn.functional.pad(src, (0, 0, 0, CH))
        return slab, src_pad

    def cover(rg, C, kw, tag):
        """Every kernel on one operator: packed_apply, the one-hot kernel
        for each precision, packed_gather_apply (bit for bit
        packed_apply's output)."""
        slab, src_pad = operands(rg, C)
        locs, ws = rg._ell_dev()
        ch, locs8, ws8 = rg._gather_dev()
        nt = dict(nty=rg.nty, ntx=rg.ntx)
        packed = isinstance(rg, PackedSlabRegridder)
        sums = (False, True) if packed else (False,)
        for cs in sums:
            args = dict(**nt, **kw, with_checksum=cs)
            run_case("packed_apply", tag, lambda: pk.packed_apply(
                slab, locs, ws, **args), lambda: pk.packed_apply_plain(
                slab, locs, ws, **args), cs)
        for prec in ("split6_bf16", "split_bf16", "highest"):
            for cs in sums:
                if packed:
                    args = dict(**nt, **kw, with_checksum=cs,
                                precision=prec)
                    run_case(
                        "onehot_apply_packed", f"{tag}_{prec}",
                        lambda: ok.onehot_apply_packed(rg.As, slab, **args),
                        lambda: ok.onehot_apply_packed_plain(rg.As, slab,
                                                             **args), cs)
                else:
                    run_case(
                        "onehot_apply", f"{tag}_{prec}",
                        lambda: ok.onehot_apply(rg.A, slab, **nt,
                                                precision=prec),
                        lambda: ok.onehot_apply_plain(rg.A, slab, **nt,
                                                      precision=prec), cs)
        rg._As = None
        for cs in sums:
            args = dict(**nt, **kw, with_checksum=cs)

            def same(got):
                k1 = pk.packed_apply(slab, locs, ws, **args)
                k1 = k1[0] if cs else k1
                return {"equal_to_packed_apply": bool(torch.equal(got, k1)),
                        "W8": rg.W8}
            run_case("packed_gather_apply", tag,
                     lambda: gk.packed_gather_apply(src_pad, ch, locs8, ws8,
                                                    W8=rg.W8, **args),
                     lambda: gk.packed_gather_apply_plain(
                         src_pad, ch, locs8, ws8, W8=rg.W8, **args), cs,
                     extra=same)

    # the packed bilinear+nearest+conserve operator at Cp = 1024 with the
    # mass-wind window (0, nz, nz) first, like the main path's pack
    cols = {"bilinear": 1024 - 2 * 16, "nearest": 16, "conserve": 16}
    pack = PackedSlabRegridder(
        [(W[k], c) for k, c in cols.items()], device,
        rotate_spec=(((0, nz, nz),), grid.cosa, grid.sina),
        cache_dir=cfg.weights_cache_dir)
    cover(pack, pack.Cp, dict(ranges=tuple(pack.ranges), rotate=pack.rotate,
                              cosa=pack._cosa_t, sina=pack._sina_t),
          "packed_conus_cp1024_rot")
    del pack
    torch.cuda.empty_cache()
    edge = SlabMatmulRegridder(W["edge1"], device,
                               cache_dir=cfg.weights_cache_dir)
    cover(edge, 128, dict(ranges=((0, 128),)), "edge1_restagger")
    del edge
    torch.cuda.empty_cache()

    # the ELL-built split_bf16 variants on the bilinear operator at 512
    # columns, the shape of the kernel_variants phase
    bil = SlabMatmulRegridder(W["bilinear"], device, precision="split_bf16",
                              cache_dir=cfg.weights_cache_dir)
    slab, _ = operands(bil, 512)
    (loc,), (wt,) = bil._ell_dev()
    nt = dict(nty=bil.nty, ntx=bil.ntx)

    def vs_v2(got):
        v2 = vk.ell_split_apply_v2(loc, wt, slab, **nt)
        rel = float((got - v2).abs().max()) / max(float(got.abs().max()),
                                                  1e-30)
        return {"W": bil.W, "vs_v2_max_rel_err": rel,
                "vs_v2_bit_identical": bool(torch.equal(got, v2)),
                "vs_v2_ok": rel <= TOL_KERNEL}
    run_case("ell_split_apply_v1", "bilinear_cp512",
             lambda: vk.ell_split_apply_v1(loc, wt, slab, **nt),
             lambda: vk.ell_split_apply_v1_plain(loc, wt, slab, **nt), False,
             extra=vs_v2)
    for cc in vk.V2_CC:
        run_case("ell_split_apply_v2", f"bilinear_cp512_cc{cc}",
                 lambda: vk.ell_split_apply_v2(loc, wt, slab, CC=cc, **nt),
                 lambda: vk.ell_split_apply_v2_plain(loc, wt, slab, **nt),
                 False)
    del bil, slab, loc, wt
    torch.cuda.empty_cache()
    summary = {}
    for c in cases:
        s = summary.setdefault(c["kernel"], {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], c["max_abs_err"])
        if "ms" in c and "ms" not in s:
            s.update(ms=c["ms"], plain_ms=c["plain_ms"], ms_case=c["case"])
    return cases, summary


# ------------------------------------------------------ write wall ----

def write_wall_phase(device, nty, ntx, packed_ms, seed):
    """The store-only kernel at the packed output shape (Cp = 1024): its
    launches counted alone, its time, and its whole output against the
    plain version bit for bit. Returns (the phase's launches, the kernel's
    summary)."""
    import numpy as np
    import torch

    from mpassit_tpu_torch.ops import write_wall as ww

    Cp = 1024
    row = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, 1, Cp)).astype(np.float32)).to(device)
    _zero_counters()
    got = ww.write_wall(row, nty=nty, ntx=ntx)
    torch.cuda.synchronize()
    ms = _time_ms(torch, lambda: ww.write_wall(row, nty=nty, ntx=ntx), 10)
    launches, plain_calls = _counters()
    ref = ww.write_wall_plain(row, nty=nty, ntx=ntx)
    equal = bool(torch.equal(got, ref))
    finite = bool(torch.isfinite(got).all())
    del got, ref
    torch.cuda.empty_cache()
    plain_ms = _time_ms(torch, lambda: ww.write_wall_plain(row, nty=nty,
                                                          ntx=ntx), 5)
    nbytes = nty * 32 * ntx * 32 * Cp * 4
    rec = {"phase": "write_wall", "shape": [nty * 32, ntx * 32, Cp],
           "out_bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
           "write_gb_per_s": nbytes / ms / 1e6,
           "plain_gb_per_s": nbytes / plain_ms / 1e6,
           "bit_identical_to_plain": equal, "finite": finite,
           "packed_apply_ms": packed_ms,
           "packed_apply_over_wall": packed_ms / ms,
           "packed_apply_share_of_write_rate": ms / packed_ms,
           "launches": launches, "plain_calls": plain_calls}
    rec["ok"] = equal and finite and _owed_only(launches, plain_calls,
                                                ("write_wall",))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"write_wall phase failed: {rec}")
    return launches, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "ms_case": f"packed_conus_cp{Cp}"}


def kernel_variants_phase(art, device, seed, reduced):
    """The kernel-variants tool in-process on this mesh's bilinear
    operator (weights from the run's cache) at the full target width and
    512 columns. Returns the phase's launches."""
    from mpassit_tpu_torch.run.pipeline import build_weights
    from mpassit_tpu_torch.tools.kernel_variants import run_variants

    W = build_weights(art.cfg, art.mesh, art.grid, art.routing)
    _zero_counters()
    t0 = time.perf_counter()
    res = run_variants(W["bilinear"], device, cols=512, seed=seed,
                       cache_dir=art.cfg.weights_cache_dir)
    t_s = time.perf_counter() - t0
    launches, plain_calls = _counters()
    ok_ = res["ok"] and _owed_only(
        launches, plain_calls, ("packed_apply", "ell_split_apply_v1",
                                "ell_split_apply_v2", "write_wall"))
    emit({"phase": "kernel_variants", "t_s": t_s, **res, "ok": ok_,
          "launches": launches, "plain_calls": plain_calls,
          "reduced": reduced + [f"ncells {art.mesh.ncells} < 2600000"]})
    if not ok_:
        raise AssertionError("kernel_variants phase failed")
    return launches


def _owed_only(launches, plain_calls, owed):
    """Every kernel in ``owed`` launched, no other, no plain call."""
    return (all(launches[k] > 0 for k in owed)
            and not any(n for k, n in launches.items() if k not in owed)
            and not any(plain_calls.values()))


# ----------------------------------------------------------------- main ----

#: kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "packed_apply": ("mpassit_tpu_torch/csrc/packed_apply.cu",
                     "mpassit_tpu/ops/pallas_matmul.py:482"),
    "onehot_apply_packed": ("mpassit_tpu_torch/csrc/onehot_apply.cu",
                            "mpassit_tpu/ops/pallas_matmul.py:482"),
    "onehot_apply": ("mpassit_tpu_torch/csrc/onehot_apply.cu",
                     "mpassit_tpu/ops/pallas_matmul.py:119"),
    "packed_gather_apply": ("mpassit_tpu_torch/csrc/packed_gather.cu",
                            "mpassit_tpu/ops/pallas_matmul.py:386"),
    "write_wall": ("mpassit_tpu_torch/csrc/write_wall.cu", "bench.py:238"),
    "ell_split_apply_v1": ("mpassit_tpu_torch/csrc/ell_split_apply.cu",
                           "tools/kernel_variants.py:34"),
    "ell_split_apply_v2": ("mpassit_tpu_torch/csrc/ell_split_apply.cu",
                           "tools/kernel_variants.py:85"),
}
#: kernel -> the phase whose launches the kernels line reports
PHASE_OF = {"packed_apply": "ell", "onehot_apply_packed": "onehot",
            "onehot_apply": "onehot", "packed_gather_apply": "gather",
            "write_wall": "write_wall",
            "ell_split_apply_v1": "kernel_variants",
            "ell_split_apply_v2": "kernel_variants"}
#: phase -> (route, switches)
ROUTES = {
    "main_path": ("ell", {}),
    "main_path_onehot": ("onehot", {"MPASSIT_ELL_KERNEL": "0"}),
    "main_path_gather": ("gather", {"MPASSIT_GATHER_KERNEL": "1"}),
}
TOL_ROUTE = 1e-6          # one-hot route vs default, rel to max|default|


def _counters():
    """(launches, plain calls) of every kernel wrapper."""
    from mpassit_tpu_torch.ops import gather_kernel as gk
    from mpassit_tpu_torch.ops import onehot_kernel as ok
    from mpassit_tpu_torch.ops import packed_kernel as pk
    from mpassit_tpu_torch.ops import variant_kernels as vk
    from mpassit_tpu_torch.ops import write_wall as ww

    return ({"packed_apply": pk.LAUNCHES, **ok.LAUNCHES,
             "packed_gather_apply": gk.LAUNCHES, "write_wall": ww.LAUNCHES,
             **vk.LAUNCHES},
            {"packed_apply": pk.PLAIN_CALLS, **ok.PLAIN_CALLS,
             "packed_gather_apply": gk.PLAIN_CALLS,
             "write_wall": ww.PLAIN_CALLS, **vk.PLAIN_CALLS})


def _zero_counters():
    from mpassit_tpu_torch.ops import gather_kernel as gk
    from mpassit_tpu_torch.ops import onehot_kernel as ok
    from mpassit_tpu_torch.ops import packed_kernel as pk
    from mpassit_tpu_torch.ops import variant_kernels as vk
    from mpassit_tpu_torch.ops import write_wall as ww

    pk.LAUNCHES = pk.PLAIN_CALLS = gk.LAUNCHES = gk.PLAIN_CALLS = 0
    ww.LAUNCHES = ww.PLAIN_CALLS = 0
    for d in (ok.LAUNCHES, ok.PLAIN_CALLS, vk.LAUNCHES, vk.PLAIN_CALLS):
        d.update(dict.fromkeys(d, 0))


def expected_launches(route, calls, fetch):
    """Kernel launches the route owes for the recorded applies: one per
    packed apply, one per FETCH-column group of a slab apply, except on
    the gather route, where a slab apply of at most FETCH columns is one
    gather launch (and a wider one takes the default route)."""
    e = dict.fromkeys(KERNELS, 0)
    for kind, Cp in calls:
        n = 1 if kind == "packed" else -(-Cp // fetch)
        if route == "onehot":
            e["onehot_apply_packed" if kind == "packed"
              else "onehot_apply"] += n
        elif route == "gather" and (kind == "packed" or Cp <= fetch):
            e["packed_gather_apply"] += 1
        else:
            e["packed_apply"] += n
    return e


def _result_arrays(res):
    out = {}
    for cat in ("diag2d", "diag3d", "patch2d", "nz3d", "nzp13d", "vert3d",
                "cons2d", "nstd2d", "soil"):
        for name, arr, *_ in getattr(res, cat, None) or []:
            out[f"{cat}.{name}"] = arr
    for name in ("u", "v", "hgt"):
        if getattr(res, name, None) is not None:
            out[name] = getattr(res, name)
    return out


def compare_results(got, ref):
    """Max abs and max rel (to the variable's max|ref|) difference over
    every result array, and whether all are bit-identical."""
    import numpy as np

    a, b = _result_arrays(got), _result_arrays(ref)
    if list(a) != list(b):
        raise AssertionError(f"result variables differ: {list(a)} {list(b)}")
    worst_abs = worst_rel = 0.0
    identical = True
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            raise AssertionError(f"{k}: shape {x.shape} != {y.shape}")
        if np.array_equal(x, y):
            continue
        identical = False
        d = float(np.abs(x.astype(np.float64) - y).max())
        worst_abs = max(worst_abs, d)
        worst_rel = max(worst_rel, d / max(float(np.abs(y).max()), 1e-30))
    return {"n_arrays": len(b), "bit_identical": identical,
            "max_abs_diff": worst_abs, "max_rel_diff": worst_rel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ncells", type=int, default=NCELLS)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "mpassit_tpu_torch")):
        print("chip_smoke: mpassit_tpu_torch/ not found next to this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1

    # --- device ----------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    has_h5py = importable("h5py")
    # the plain one-hot versions' "highest" product needs full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "h5py": has_h5py, "ninja": importable("ninja"),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    device = torch.device("cuda", 0)

    # --- build: one nvcc per source, all started together ----------------
    from concurrent.futures import ThreadPoolExecutor

    from mpassit_tpu_torch.ops import gather_kernel as gk
    from mpassit_tpu_torch.ops import onehot_kernel as ok
    from mpassit_tpu_torch.ops import packed_kernel as pk
    from mpassit_tpu_torch.ops import variant_kernels as vk
    from mpassit_tpu_torch.ops import write_wall as ww

    mods = (pk, ok, gk, ww, vk)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        for f in [ex.submit(m.build) for m in mods]:
            f.result()
    emit({"phase": "build", "build_s": time.perf_counter() - t0,
          "sources": [{"source": os.path.relpath(m.SOURCE, HERE),
                       "so": os.path.relpath(m.BUILD_INFO["so"], HERE),
                       "nvcc_s": m.BUILD_INFO["seconds"]} for m in mods]})
    for m in mods:
        for line in m.BUILD_INFO["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {os.path.basename(m.SOURCE)}:", line.strip())

    # --- inputs ----------------------------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    nml, info = prepare_inputs(WORK, os.path.join(HERE, "parm"),
                               args.ncells, args.seed, classic=not has_h5py)
    reduced = ([f"ncells {args.ncells} < {NCELLS}"]
               if args.ncells < NCELLS else [])
    emit({"phase": "inputs", "t_s": time.perf_counter() - t0,
          "reduced": reduced, **{k: v for k, v in info.items()
                                 if k != "namelist"}})
    print(info["namelist"], end="")

    # --- the main path, once per apply route ------------------------------
    import gc

    import numpy as np

    from mpassit_tpu_torch.ops import matmul_apply
    from mpassit_tpu_torch.run import pipeline

    arts, calls = [], []
    run_pipeline = pipeline.run_pipeline

    def observed_run(cfg, device, dtype=None):
        art = run_pipeline(cfg, device, dtype)
        arts.append(art)
        return art

    def record(cls, kind):
        orig = cls.apply_np

        def wrapped(self, src, *a, **kw):
            blocks = src if isinstance(src, (list, tuple)) else [src]
            C = sum(1 if np.ndim(b) == 1 else np.shape(b)[1]
                    for b in blocks)
            calls.append((kind, C + (-C) % matmul_apply.LANE))
            return orig(self, src, *a, **kw)
        cls.apply_np = wrapped

    pipeline.run_pipeline = observed_run
    record(matmul_apply.PackedSlabRegridder, "packed")
    record(matmul_apply.SlabMatmulRegridder, "slab")
    # where interp_data goes: host->device source upload, one-hot operator
    # build, gather-layout build, kernel launches, device->host strip
    # fetch, each bracketed by synchronizes
    split = {}
    split_keys = {"_src_to_device": "upload_s", "_build_A_T": "build_A_s",
                  "_chunk_slab_cached": "chunk_layout_s",
                  "packed_apply": "kernel_s", "onehot_apply": "kernel_s",
                  "onehot_apply_packed": "kernel_s",
                  "packed_gather_apply": "kernel_s",
                  "_fetch_strips": "fetch_s"}

    def timed(name, key):
        fn = getattr(matmul_apply, name)

        def wrapped(*a, **kw):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize(device)
            split[key] = split.get(key, 0.0) + time.perf_counter() - t
            return r
        setattr(matmul_apply, name, wrapped)

    for name, key in split_keys.items():
        timed(name, key)
    if not has_h5py:
        # the NetCDF4 output writer needs h5py; the result is kept instead
        pipeline.write_output = lambda path, cfg, grid, data, res: None
        print(json.dumps({"output_write":
                          "captured in memory: h5py not installed"}))
        # the shared classic-format reader (mpassit_tpu/io/nc4.py::_decode)
        # imports h5py only to test attribute values against h5py.Empty,
        # which scipy never returns: a module holding that class stands in
        shim = types.ModuleType("h5py")
        shim.Empty = type("Empty", (), {})
        sys.modules["h5py"] = shim
        print(json.dumps({"h5py_shim": "h5py.Empty stub for the classic "
                          "reader's attribute decode"}))
    os.environ["MPASSIT_PLATFORM"] = "cuda"
    route_launches, default_art = {}, None
    for phase, (route, switches) in ROUTES.items():
        for k in ("MPASSIT_ELL_KERNEL", "MPASSIT_GATHER_KERNEL"):
            os.environ.pop(k, None)
        os.environ.update(switches)
        arts.clear()
        calls.clear()
        split.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        _zero_counters()
        t0 = time.perf_counter()
        rc = pipeline.main([nml])
        t_main = time.perf_counter() - t0
        launches, plain_calls = _counters()
        art = arts[0] if arts else None
        expected = expected_launches(route, calls, matmul_apply.FETCH)
        emit({"phase": phase, "switches": switches, "rc": rc, "t_s": t_main,
              "stages_s": art.timings.stages if art else {},
              "interp_data_split_s": dict(split), "launches": launches,
              "expected_launches": expected, "applies": list(calls),
              "plain_calls": plain_calls,
              "peak_device_gb": torch.cuda.max_memory_allocated(device) / 1e9,
              "out_shape": [art.grid.ny, art.grid.nx] if art else None,
              "reduced": reduced})
        if rc != 0 or art is None:
            raise SystemExit(f"{phase} failed: rc={rc}")
        own = [k for k, n in expected.items() if n and k != "packed_apply"]
        if (launches != expected or any(plain_calls.values())
                or not any(launches.values())
                or (route != "ell" and (launches["packed_apply"] or not own))):
            raise SystemExit(
                f"{phase} did not run every apply through the route's "
                f"kernels: launches={launches} expected={expected} "
                f"plain_calls={plain_calls}")
        route_launches[route] = launches
        # the run's device tensors (operators, one-hot A) go before the next
        art.regridders.clear()
        gc.collect()
        torch.cuda.empty_cache()

        # --- check ------------------------------------------------------
        t0 = time.perf_counter()
        errs = check_outputs(art, 4000, args.seed)
        written = None
        if has_h5py and route == "ell":
            from mpassit_tpu.io.nc4 import open_dataset

            with open_dataset(art.cfg.output_file) as f:
                names = set(f.var_names())
                missing = [n for n in errs if n not in names]
                if missing:
                    raise AssertionError(f"output file lacks {missing}")
                u = f.read_var("U")
                if u.shape != (1, NZ, art.grid.ny, art.grid.nx + 1):
                    raise AssertionError(f"U in file has shape {u.shape}")
                written = os.path.getsize(art.cfg.output_file)
        check = {"phase": "check", "route": route,
                 "t_s": time.perf_counter() - t0, "tol_rel": TOL_REL,
                 "max_rel_err": max(errs.values()), "n_vars": len(errs),
                 "output_bytes": written, "per_var_max_rel_err": errs}
        if default_art is None:
            default_art = art
        else:
            diff = compare_results(art.result, default_art.result)
            check["vs_default_route"] = diff
            ok_route = (diff["bit_identical"] if route == "gather"
                        else diff["max_rel_diff"] <= TOL_ROUTE)
            check["vs_default_ok"] = ok_route
            if not ok_route:
                emit(check)
                raise AssertionError(f"{phase} differs from the default "
                                     f"route: {diff}")
            art.result = art.data = None
        emit(check)
        del art
    for k in ("MPASSIT_ELL_KERNEL", "MPASSIT_GATHER_KERNEL"):
        os.environ.pop(k, None)

    # --- kernel vs plain, the write wall, the kernel variants --------------
    cases, summary = kernel_vs_plain(default_art, device, args.seed)
    grid = default_art.grid
    phase_launches = dict(route_launches)
    phase_launches["write_wall"], summary["write_wall"] = write_wall_phase(
        device, -(-grid.ny // 32), -(-grid.nx // 32),
        summary["packed_apply"]["ms"], args.seed)
    phase_launches["kernel_variants"] = kernel_variants_phase(
        default_art, device, args.seed, reduced)
    del default_art, arts[:], grid
    shutil.rmtree(WORK, ignore_errors=True)

    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": phase_launches[PHASE_OF[name]][name],
        **summary[name]} for name, (source, replaces) in KERNELS.items()]
    emit({"kernels": kernels})
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        raise SystemExit(f"kernels not launched on their phase: {idle}")
    print(nvidia_smi())
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
