#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mpassit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--ncells N]

Run from the root of a checkout. It needs a CUDA device and exits 1
without one; it imports nothing of JAX or of the JAX package's
device-bound modules. Phases, each printing one JSON line:

- device: the card (name and power limit from nvidia-smi), torch and CUDA
  versions, whether h5py and ninja are importable;
- build: compiles mpassit_tpu_torch/csrc/packed_apply.cu with nvcc;
- inputs: a synthetic global MPAS mesh of 655,362 cells (the size of
  MPAS's x1.655362 30-km mesh), nz=55, nsoil=4, with seeded smooth fields
  for every variable of the shipped parm/ varlists, written as NetCDF4
  (or as CDF-2 through scipy when h5py is missing);
- main_path: the CLI function ``mpassit_tpu_torch.run.pipeline.main``
  on the shipped parm/namelist.input target (Lambert CONUS 3 km), its
  file paths pointed at the inputs and a weights cache under .bench_cache/;
  the kernel launch counters are zeroed just before and read just after;
- check: sampled target points of every output variable against a
  float64 numpy evaluation sum(w * src[idx]) of the same ELL weights
  (after an f64 Q4 rotation for the winds), bound 1e-6 of the variable's
  largest sampled magnitude;
- kernel_vs_plain: the kernel against its plain PyTorch version on the
  card, at the main path's shapes: the packed bilinear+nearest+conserve
  pack of this mesh and grid at Cp=1024 with the (0, 55, 55) rotate window
  (with and without checksum) and the EDGE1 restagger pack; median times
  by CUDA events after a warm-up.

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
    """The kernel against packed_apply_plain on the card at the main
    path's shapes. Returns (per-case results, kernel summary)."""
    import numpy as np
    import torch

    from mpassit_tpu_torch.ops import packed_kernel as pk
    from mpassit_tpu_torch.ops.matmul_apply import (
        PackedSlabRegridder,
        SlabMatmulRegridder,
    )
    from mpassit_tpu_torch.run.pipeline import build_weights

    cfg, grid = art.cfg, art.grid
    W = build_weights(cfg, art.mesh, grid, art.routing)
    rng = np.random.default_rng(seed)
    nz = art.mesh.nz
    # the packed bilinear+nearest+conserve operator at Cp = 1024 with the
    # mass-wind window (0, nz, nz) first, like the main path's pack
    cols = {"bilinear": 1024 - 2 * 16, "nearest": 16, "conserve": 16}
    pack = PackedSlabRegridder(
        [(W[k], c) for k, c in cols.items()], device,
        rotate_spec=(((0, nz, nz),), grid.cosa, grid.sina),
        cache_dir=cfg.weights_cache_dir)
    edge = SlabMatmulRegridder(W["edge1"], device,
                               cache_dir=cfg.weights_cache_dir)
    cases = []

    def run_case(name, rg, C, kw, checksum):
        src = torch.from_numpy(
            rng.standard_normal((rg.n_src, C)).astype(np.float32)).to(device)
        slab = torch.index_select(src, 0, rg.slab_idx).view(
            rg.n_tiles, rg.W, C)
        del src
        if isinstance(rg, PackedSlabRegridder):
            locs, ws = rg._ell_dev()
        else:
            locs, ws = (rg._ell_dev()[0],), (rg._ell_dev()[1],)
        args = dict(nty=rg.nty, ntx=rg.ntx, with_checksum=checksum, **kw)
        got = pk.packed_apply(slab, locs, ws, **args)
        torch.cuda.synchronize()
        ref = pk.packed_apply_plain(slab, locs, ws, **args)
        torch.cuda.synchronize()
        out = {"case": name, "shape": list(slab.shape),
               "checksum": checksum}
        if checksum:
            (got, gcs), (ref, rcs) = got, ref
            out["checksum_max_rel_err"] = float(
                ((gcs.double() - rcs.double()).abs()
                 / rcs.double().abs().clamp_min(1e-30)).max())
        d = (got - ref).abs()
        scale = float(ref.abs().max())
        out.update(max_abs_err=float(d.max()), max_abs_plain=scale,
                   max_rel_err=float(d.max()) / max(scale, 1e-30),
                   finite=bool(torch.isfinite(got).all()))
        del got, ref, d
        if not checksum:
            out["ms"] = _time_ms(torch, lambda: pk.packed_apply(
                slab, locs, ws, **args), 10)
            out["plain_ms"] = _time_ms(torch, lambda: pk.packed_apply_plain(
                slab, locs, ws, **args), 5)
            if out["ms"] > out["plain_ms"]:
                out["note"] = "kernel slower than plain"
        torch.cuda.empty_cache()
        ok = (out["finite"] and out["max_rel_err"] <= TOL_KERNEL
              and out.get("checksum_max_rel_err", 0.0) <= 1e-5)
        out["ok"] = ok
        cases.append(out)
        emit({"phase": "kernel_vs_plain", **out})
        if not ok:
            raise AssertionError(f"kernel disagrees with plain: {out}")

    pk_kw = dict(ranges=tuple(pack.ranges), rotate=pack.rotate,
                 cosa=pack._cosa_t, sina=pack._sina_t)
    run_case("packed_conus_cp1024_rot", pack, pack.Cp, pk_kw, False)
    run_case("packed_conus_cp1024_rot", pack, pack.Cp, pk_kw, True)
    run_case("edge1_restagger", edge, 128, dict(ranges=((0, 128),)), False)
    main = cases[0]
    return cases, {"max_abs_err": max(c["max_abs_err"] for c in cases),
                   "ms": main["ms"], "plain_ms": main["plain_ms"]}


# ----------------------------------------------------------------- main ----

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
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "h5py": has_h5py, "ninja": importable("ninja")})
    device = torch.device("cuda", 0)

    # --- build -----------------------------------------------------------
    from mpassit_tpu_torch.ops import packed_kernel as pk

    t0 = time.perf_counter()
    pk.build()
    emit({"phase": "build", "source": os.path.relpath(pk.SOURCE, HERE),
          "so": os.path.relpath(pk.BUILD_INFO["so"], HERE),
          "nvcc_s": pk.BUILD_INFO["seconds"],
          "build_s": time.perf_counter() - t0})
    for line in pk.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

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

    # --- main path -------------------------------------------------------
    from mpassit_tpu_torch.ops import matmul_apply
    from mpassit_tpu_torch.run import pipeline

    arts, applies = [], {"packed": 0, "slab_groups": 0}
    run_pipeline = pipeline.run_pipeline

    def observed_run(cfg, device, dtype=None):
        art = run_pipeline(cfg, device, dtype)
        arts.append(art)
        return art

    def count(cls, key, groups):
        orig = cls.apply_np

        def wrapped(self, src, *a, **kw):
            applies[key] += groups(self, src)
            return orig(self, src, *a, **kw)
        cls.apply_np = wrapped

    def slab_groups(rg, src):
        import numpy as np

        blocks = src if isinstance(src, (list, tuple)) else [src]
        C = sum(1 if np.ndim(b) == 1 else np.shape(b)[1] for b in blocks)
        Cp = C + (-C) % matmul_apply.LANE
        return -(-Cp // matmul_apply.FETCH)

    pipeline.run_pipeline = observed_run
    count(matmul_apply.PackedSlabRegridder, "packed", lambda rg, s: 1)
    count(matmul_apply.SlabMatmulRegridder, "slab_groups", slab_groups)
    # where interp_data goes: host->device source upload, kernel launches,
    # device->host strip fetch, each bracketed by synchronizes
    split = {"upload_s": 0.0, "kernel_s": 0.0, "fetch_s": 0.0}

    def timed(name, key):
        fn = getattr(matmul_apply, name)

        def wrapped(*a, **kw):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize(device)
            split[key] += time.perf_counter() - t
            return r
        setattr(matmul_apply, name, wrapped)

    timed("_src_to_device", "upload_s")
    timed("packed_apply", "kernel_s")
    timed("_fetch_strips", "fetch_s")
    captured = {}
    if not has_h5py:
        # the NetCDF4 output writer needs h5py; capture the result instead
        def capture(path, cfg, grid, data, res):
            captured["res"] = res
        pipeline.write_output = capture
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
    torch.cuda.reset_peak_memory_stats(device)
    pk.LAUNCHES = 0
    pk.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    rc = pipeline.main([nml])
    t_main = time.perf_counter() - t0
    launches, plain_calls = pk.LAUNCHES, pk.PLAIN_CALLS
    art = arts[0] if arts else None
    stages = art.timings.stages if art else {}
    expected = applies["packed"] + applies["slab_groups"]
    emit({"phase": "main_path", "rc": rc, "t_s": t_main,
          "stages_s": stages, "interp_data_split_s": split,
          "launches": launches,
          "expected_launches": expected, "applies": applies,
          "plain_calls": plain_calls,
          "peak_device_gb": torch.cuda.max_memory_allocated(device) / 1e9,
          "out_shape": [art.grid.ny, art.grid.nx] if art else None,
          "reduced": reduced})
    if rc != 0 or art is None:
        raise SystemExit(f"main path failed: rc={rc}")
    if launches != expected or launches == 0 or plain_calls != 0:
        raise SystemExit("main path did not run every apply through the "
                         f"kernel: launches={launches} expected={expected} "
                         f"plain_calls={plain_calls}")

    # --- check -----------------------------------------------------------
    t0 = time.perf_counter()
    errs = check_outputs(art, 4000, args.seed)
    written = None
    if has_h5py:
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
    emit({"phase": "check", "t_s": time.perf_counter() - t0,
          "tol_rel": TOL_REL, "max_rel_err": max(errs.values()),
          "n_vars": len(errs), "output_bytes": written,
          "per_var_max_rel_err": errs})

    # --- kernel vs plain ---------------------------------------------------
    cases, summary = kernel_vs_plain(art, device, args.seed)
    del art, arts[:], captured
    shutil.rmtree(WORK, ignore_errors=True)

    emit({"kernels": [{
        "name": "packed_apply", "route": "cuda",
        "source": "mpassit_tpu_torch/csrc/packed_apply.cu",
        "replaces": "mpassit_tpu/ops/pallas_matmul.py:482",
        "launches": launches, **summary}]})
    print(nvidia_smi())
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
