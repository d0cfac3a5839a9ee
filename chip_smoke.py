#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mpassit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--ncells N]

Run from the root of a checkout. It needs a CUDA device and exits 1
without one; it imports nothing of JAX and nothing of the JAX package
(mpassit_tpu): the port carries its own host layers. Phases, each printing
one JSON line:

- device: the card (name and power limit from nvidia-smi), torch and CUDA
  versions, whether h5py and ninja are importable and whether
  ``io/netcdf_c.available()`` finds a libnetcdf;
- build: compiles the five CUDA sources of mpassit_tpu_torch/csrc/ with
  nvcc, one process each, and the HDF5 filter decoders
  (csrc/h5_filters.cpp) with g++, all started together; for the two
  tensor-core sources,
  onehot_apply.cu and ell_split_apply.cu, the registers, spills and shared
  memory of each kernel (the -Xptxas -v log) and the counts of HGMMA and
  HMMA (tensor-core) and FFMA instructions in their SASS (cuobjdump
  -sass); HGMMA must not be 0 in either;
- inputs: a synthetic global MPAS mesh of 655,362 cells (the size of
  MPAS's x1.655362 30-km mesh; kept on disk in the mesh cache of
  tools/kernel_variants.py, where production_e2e finds it), nz=55,
  nsoil=4, with seeded smooth fields
  for every variable of the shipped parm/ varlists and the vertex field
  ``vorticity``, written as NetCDF4
  (or, when h5py is missing, as CDF-2 through scipy with ``Time`` the
  record dimension, as MPAS writes it: the history file's record data
  passes 2 GiB, which the port's own classic parser reads);
- main_path, main_path_onehot, main_path_gather: the CLI function
  ``mpassit_tpu_torch.run.pipeline.main`` on the shipped
  parm/namelist.input target (Lambert CONUS 3 km), its file paths pointed
  at the inputs and a weights cache under .bench_cache/, once per apply
  route: the default, MPASSIT_ELL_KERNEL=0 (one-hot kernels) and
  MPASSIT_GATHER_KERNEL=1 (in-kernel gather; the later runs find the
  weights cache warm). Every kernel's launch and plain-call counters are
  zeroed just before each run and read just after, against the launches
  the route owes for the applies it made; stage timings, the
  ``interp_data_split_s`` (the run's own ``apply.*`` and ``weights.pack``
  stages, from its spans: host clock, no synchronize, so a fetch includes
  its wait for the group's kernel) and peak device memory per run;
- check (per route): sampled target points of every output variable
  against a float64 numpy evaluation sum(w * src[idx]) of the same ELL
  weights (after an f64 Q4 rotation for the winds), bound 1e-6 of the
  variable's largest sampled magnitude; the gather route's result must
  equal the default route's bit for bit, the one-hot route's within 1e-6
  of each variable's largest magnitude;
- main_path_written: the normal entry point, ``python -m
  mpassit_tpu_torch`` on the shipped namelist, as a child process on the
  card (weights cache warm, write_output not patched: the in-process runs
  above and below keep their result in memory and write no file, to keep
  the run's time). Its NetCDF4 file is written by the port's own HDF5
  encoder (io/hdf5.py; no h5py on the card) and read back through
  ``open_dataset`` (the port's HDF5 reader where h5py is missing); every
  variable, level by level, must be bit for bit what the in-memory writer
  stores from main_path's result (tools/bench_production.py's digest
  stand-in). It prints the child's exit code and Timings stages
  (``write_to_file``), the file's bytes, the read-back seconds, the
  variables that match and differ, nvidia-smi's name and power limit, the
  seconds of the reference digest (the in-memory writer's code on the
  stand-in, in this process) and of the whole phase.
  With less than twice the file's bytes free it runs at a smaller target
  grid of the same extent, listed in ``reduced``;
- main_path_matrix: the CLI function on the same inputs and shipped
  varlists (919 packed columns, full width), its target replaced once per
  MATRIX entry: mercator (450x265 at 12 km), polar stereographic (400x400
  at 15 km), regional lat-lon (700x270 at 0.1 degree), global lat-lon
  (1200x600 at 0.3 degree: nx not a multiple of 32, pole rows and the
  seam) and two file targets of tests/data/nc4_foreign, read by the
  port's own HDF5 reader: the committed 150x100 36-km Lambert fixture
  written by netCDF-C (superblock 2, dense attributes, deflated chunks)
  and the 60x45 30-km one h5py wrote with libver "latest" (superblock 3,
  extensible- and fixed-array chunk indexes, szip, LZF, scale-offset, a
  huge attribute; the filter decoders built with g++); each grid
  cut to keep the phase within MATRIX_BUDGET_S (180 s), its cut in
  ``reduced``, weights cold. Per run: packed_apply's 3 launches (the
  pack, EDGE1, EDGE2) against those owed and no plain call, the pack's
  rotation window only on the Lambert (file) target, every variable
  within TOL_REL of the float64 evaluation of the check phase (Q4 only on
  Lambert), its stages and peak device memory. Then the committed
  fixtures read through the port's HDF5 reader against their manifest
  (h5py's read, made with them), the reader's decode MB/s per chunk index
  and filter on the h5py fixture (``decode_mb_s``, beside nvidia-smi's
  name and power limit), and the phase's seconds;
- main_path_sharded: the CLI on the default route once more, unsharded
  (caches warm: this phase's yardstick), then with n_device_shards = -1
  as a world of one process over NCCL (MPASSIT_COORDINATOR,
  MPASSIT_NUM_PROCESSES=1, MPASSIT_PROCESS_ID=0; the process group is
  started by the CLI function and destroyed when it returns), once per
  source_decomp: replicate must be bit for bit the default route's result
  with packed_apply's 3 launches on the rank's band of tile rows; ring and
  allgather (plain torch engines, no kernel) within TOL_REL of the float64
  evaluation, as the check phase measures. Each line has interp_data, its
  split with the band gather (``band_gather_s``), peak device memory and
  the unsharded run's; then main_path_sharded_ranks: with two cards or
  more, the CLI as one process per card over NCCL on the replicate and
  ring namelists beside one unsharded process (the file write left out
  to keep the run's time; rank 0 dumps its results through
  MPASSIT_DUMP_RESULT): the unsharded process and replicate bit for bit
  the default route, ring within 1e-6 of each variable's largest
  magnitude of it, with rank 0's stages and every rank's wall and peak
  device memory; with one card a line saying it was not run and why;
- main_path_profiled: the CLI on the default route, weights cache warm,
  once unprofiled and then with MPASSIT_PROFILE set: every variable must
  be bit for bit the unprofiled default run's; the trace must hold
  packed_apply's kernel under its own symbol (``ell_apply_kernel<SlabRows``)
  as often as its launch counter counts, the launches owed (3), on the
  stream of torch's own kernels. It prints tools/trace_summary.py's
  device idle share of the run and of each stage, with the top device
  operations and the longest idle gaps of the run and of interp_data, and
  the profiled interp_data against the unprofiled one (the profiler's
  overhead);
- main_path_streamed: the production configuration of the JAX package's
  tools/bench_production.py: the CLI with stream_output = .true. on a copy
  of parm/ whose histlist_3d adds the vertex field ``vorticity VORT``
  (seeded in the same history file), MPASSIT_DEVICE_BUDGET_GB=4 on the
  default route, so the packed apply runs in column groups. A
  StripRecorder stands in for the NetCDF4 StreamingWriter (to keep the
  run's time) and keeps no copy of the output: every put must be bit for bit
  the same levels of the default route's result (rotated U10/V10 and U/V
  included), VORT within TOL_REL of a float64 evaluation of the vertex
  weights at sampled points, every var and level must arrive once;
  launches against those owed, with the group width read from the
  regridder's own call; no plain call; peak device memory below the
  default route's and within the budget. Its ``write_to_file`` is the
  recorder's time, not a file write;
- kernel_vs_plain: each kernel against its plain PyTorch version on the
  card, at the main path's shapes: the packed bilinear+nearest+conserve
  pack of this mesh and grid at Cp=1024 with the (0, 55, 55) rotate window
  (with and without checksum) and the EDGE1 restagger pack (W ~ 1096,
  Cp=128); packed_apply and onehot_apply_packed (split6_bf16) on the
  first group (rotation) and the last group (the methods' tails and the
  zero tail) of main_path_streamed's grouped pack, each also bit for bit
  (torch.equal on the device) the same columns of its own full-width
  output; packed_apply on main_path_matrix's mercator pack (its own
  column counts, no rotation window: the kernel's launch off Lambert,
  with its launches from that run); the one-hot kernels for each
  precision, with the number of bf16 product terms and the achieved
  tensor-core TFLOP/s at the padded K (ops/onehot_kernel.launch_plan);
  the gather kernel also
  bit for bit against packed_apply; the ELL-built split_bf16 variants v1
  and v2 (CC 128 and 256) on the bilinear operator at 512 columns, within
  1e-6 of max|plain|, v1 bit for bit v2 at both CCs
  (``vs_v2_bit_identical``, required) and their tensor-core TFLOP/s at
  the padded K (ops/variant_kernels.ell_split_plan); median times by CUDA events
  after a warm-up; per timed case its bound (``bound_ms``: the larger of
  the bytes it must move, each counted once, over 3.35 TB/s and its
  operations over the peak rate of their type), ``of_bound`` (bound over
  time), the launches of the kernel on its route's main-path run
  (``launches_per_run``) and ``library_ms``, one PyTorch call of the same
  function on the same operands used only as a yardstick: torch.sparse.mm
  over a CSR of the ELL arrays (one call per method range, summed; it
  neither unblocks nor rotates, and for v1/v2 it computes f32 products,
  not split_bf16) for packed_apply, packed_gather_apply and v1/v2,
  torch.bmm in f32 (TF32 off) for the one-hot kernels;
- write_wall: the store-only kernel at the packed output shape (Cp=1024)
  bit for bit against its plain version over the whole output, its write
  GB/s, and packed_apply's and onehot_apply_packed's (split6_bf16) times
  as multiples of it (the measured write roofline of the apply); its bound
  and ``library_ms`` (Tensor.fill_ of the same tensor);
- kernel_variants: the tool mpassit_tpu_torch.tools.kernel_variants
  (v0 = packed_apply, v1, v2 at CC 128 and 256, the write wall at 512
  columns) on this mesh's cached bilinear operator at the full target
  width, with its spot checks (v1 vs v2 within 1e-6, v1 vs v0 within 3e-5
  of max|v0|);
- production_e2e: mpassit_tpu_torch.tools.bench_production at this mesh
  size with ``--writer digest`` (the two runs' 7-GB files would not fit
  the disk budget beside the smoke's own): its inputs, the
  warmed weights, then the streamed and the in-memory run each in a
  process of its own, their stages, peak host and device memory and
  pre-first-apply costs, and the fetch probe. It fails unless both
  children exit 0 and their digest maps are equal and complete. It prints
  the tool's JSON with ``reduced``.

The counters of every kernel are zeroed just before each phase that drives
a path (the three main-path routes, each run of main_path_matrix and of
main_path_sharded, main_path_profiled, main_path_streamed, write_wall,
kernel_variants) and read just after; the kernels line takes each
kernel's launches from the phase that runs it.

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

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".bench_cache", "chip_smoke")
NCELLS = 655_362          # MPAS x1.655362 (30-km quasi-uniform) cell count
NZ, NSOIL = 55, 4
TOL_REL = 1e-6            # f32 apply vs f64 oracle (register R10 class)
TOL_KERNEL = 1e-6         # kernel vs plain, relative to max|plain|
#: main_path_streamed's MPASSIT_DEVICE_BUDGET_GB: below one full-width pass
#: of the CONUS pack (11.1 GB), so its packed apply runs in column groups
BUDGET_GB = 4
#: main_path_sharded's runs, by source_decomp
SHARDED = ("replicate", "ring", "allgather")
#: main_path_matrix's targets: the namelist lines of each grid (in place of
#: the shipped namelist's Lambert CONUS block) and the cut that keeps the
#: phase within MATRIX_BUDGET_S
MATRIX = {
    "mercator": ([
        "target_grid_type = 'mercator'", "nx = 451", "ny = 266",
        "dx = 12000.0", "dy = 12000.0", "ref_lat = 38.5", "ref_lon = -97.5",
        "truelat1 = 20.0", "stand_lon = -97.5"],
        "mercator 450x265 at 12 km < 1800x1060 at 3 km (the shipped "
        "CONUS extent)"),
    "polar": ([
        "target_grid_type = 'polar'", "nx = 401", "ny = 401",
        "dx = 15000.0", "dy = 15000.0", "ref_lat = 65.0",
        "ref_lon = -100.0", "truelat1 = 60.0", "stand_lon = -100.0"],
        "polar stereographic 400x400 at 15 km (6000 km square) < 3 km"),
    "latlon_regional": ([
        "target_grid_type = 'lat-lon'", "nx = 701", "ny = 271",
        "dx = 0.1", "dy = 0.1", "ref_lat = 37.0", "ref_lon = -95.0",
        "is_regional = .true."],
        "regional lat-lon 700x270 at 0.1 degree < 0.03 degree (3 km) "
        "over CONUS"),
    # 0.3 degree: 1200 columns (not a multiple of 32), fine enough that a
    # tile of 32x32 points reads at most W_CAP = 2048 of the mesh's cells
    # (the pack's W is in the phase's line); on a coarser grid the pack is
    # not built and the methods run as separate applies
    "latlon_global": ([
        "target_grid_type = 'lat-lon'", "nx = 1201", "ny = 601",
        "stand_lon = 0.0", "is_regional = .false."],
        "global lat-lon 1200x600 (0.3 degree) < 1440x720 (0.25 degree)"),
    "file": ([
        "target_grid_type = 'file'",
        'file_target_grid = "{fixtures}/wrf_lambert_target.nc"'],
        "file target: the committed 150x100 36-km netCDF-C fixture < "
        "1800x1060 at 3 km"),
    # written by h5py with libver "latest": extensible- and fixed-array
    # chunk indexes, szip, LZF, scale-offset, a huge attribute
    "file_latest": ([
        "target_grid_type = 'file'",
        'file_target_grid = "{fixtures}/wrf_lambert_latest.nc"'],
        "file target: the committed 60x45 30-km h5py fixture < 1800x1060 "
        "at 3 km"),
}
#: the namelist keys a MATRIX entry replaces
GRID_KEYS = ("target_grid_type", "nx", "ny", "dx", "dy", "ref_lat",
             "ref_lon", "truelat1", "truelat2", "stand_lon", "output_file")
MATRIX_BUDGET_S = 180
#: the committed netCDF-C fixtures and their manifest
FIXTURES = os.path.join(HERE, "tests", "data", "nc4_foreign")
#: the H100 SXM's published rates (NVIDIA data sheet; at 700 W): device
#: memory bytes/s, dense bf16 tensor-core and f32 CUDA-core FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


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
    from mpassit_tpu_torch.fields.registry import U_VAR, V_VAR

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


def _vorticity_parm(parm, work):
    """A copy of ``parm``'s varlists whose histlist_3d ends with the
    vertex-located ``vorticity VORT``, as tools/bench_production.py builds
    the production load; returns its directory."""
    vd = os.path.join(work, "parm_vorticity")
    os.makedirs(vd, exist_ok=True)
    for name in ("diaglist", "histlist_2d", "histlist_3d", "histlist_soil"):
        with open(os.path.join(parm, name)) as f:
            body = f.read()
        if name == "histlist_3d":
            body = body.rstrip("\n") + "\nvorticity VORT\n"
        with open(os.path.join(vd, name), "w") as f:
            f.write(body)
    return vd


def _namelist(parm, repl, extra):
    """The shipped namelist with the ``repl`` keys replaced and the
    ``extra`` lines added before its end."""
    lines = []
    with open(os.path.join(parm, "namelist.input")) as f:
        for line in f:
            key = line.split("=")[0].strip().lower()
            if key in repl:
                line = f' {key} = "{repl[key]}"\n'
            elif line.strip() == "/":
                line = "".join(f" {e}\n" for e in extra) + "/\n"
            lines.append(line)
    return "".join(lines)


def prepare_inputs(work, parm, ncells, seed, classic):
    """Mesh, grid/diag/hist files and the namelists under ``work``: the
    shipped namelist on the shipped varlists, the streamed one
    (stream_output = .true.) on a copy of them with the vertex field
    ``vorticity`` (whose seeded field the history file holds for both),
    and the shipped one sharded (n_device_shards = -1) with each
    source_decomp of SHARDED. Returns the namelist paths in that order and
    what was written."""
    import numpy as np

    from mpassit_tpu_torch.fields.registry import build_routing
    from mpassit_tpu_torch.tools.kernel_variants import _cached_mesh

    if classic:
        from mpassit_tpu_torch.testing import (
            write_data_file_classic as write_data,
            write_grid_file_classic as write_grid,
        )
    else:
        from mpassit_tpu_torch.mesh.synthetic import (
            write_mpas_data_file as write_data,
            write_mpas_grid_file as write_grid,
        )
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    # kept on disk as tools/bench_production.py looks for it (seed 1 there)
    mesh = _cached_mesh(work, ncells, NZ, NSOIL, seed=seed + 1)
    t_mesh = time.perf_counter() - t0
    vparm = _vorticity_parm(parm, work)
    routing = build_routing(vparm, True, True, True)
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
    repl = {"grid_file_input_grid": paths["grid"],
            "hist_file_input_grid": paths["hist"],
            "diag_file_input_grid": paths["diag"],
            "output_file": os.path.join(work, "mpassit_out.nc")}
    cache = f'weights_cache_dir = "{os.path.join(work, "weights")}"'
    texts = {"namelist.input": _namelist(
                 parm, repl, [f'varlist_dir = "{parm}"', cache]),
             "namelist_streamed.input": _namelist(
                 parm, repl, [f'varlist_dir = "{vparm}"', cache,
                              "stream_output = .true."])}
    for decomp in SHARDED:
        texts[f"namelist_sharded_{decomp}.input"] = _namelist(
            parm, repl, [f'varlist_dir = "{parm}"', cache,
                         "n_device_shards = -1",
                         f'source_decomp = "{decomp}"'])
    nmls = []
    for name, text in texts.items():
        nmls.append(os.path.join(work, name))
        with open(nmls[-1], "w") as f:
            f.write(text)
    in_bytes = sum(os.path.getsize(p) for p in paths.values())
    return nmls, {"ncells": mesh.ncells, "nvertices": mesh.nvertices,
                  "nz": NZ, "nsoil": NSOIL, "seed": seed,
                  "format": ("CDF-2 (scipy), record Time" if classic
                             else "NetCDF4 (io/hdf5.py)"),
                  "input_bytes": in_bytes, "t_mesh_s": t_mesh,
                  "namelist": texts["namelist.input"]}


# ---------------------------------------------------------------- check ----

def ell_f64(ell, pts, src):
    """sum_k w * src[idx] at target points ``pts``, in float64:
    (len(pts), columns of ``src``)."""
    import numpy as np

    s = np.asarray(src, np.float64)
    s = s[:, None] if s.ndim == 1 else s
    return np.einsum("pk,pkc->pc", np.asarray(ell.w, np.float64)[pts],
                     s[np.asarray(ell.idx)[pts]])


def run_weights(art, file_order=False):
    """The weights the run of ``art`` applied, built on its renumbered
    cells (``renumbered_cells``), so the weight cache's entries; with
    ``file_order`` the cell methods' source indices mapped back to the
    input file's cell order, the order of ``art.mesh`` and ``art.data``."""
    import dataclasses

    from mpassit_tpu_torch.run.pipeline import (
        CELL_KEYS,
        build_weights,
        renumbered_cells,
    )

    ro = renumbered_cells(art.cfg, art.mesh, art.grid)
    W = build_weights(art.cfg, art.mesh if ro is None else ro.mesh,
                      art.grid, art.routing)
    if file_order and ro is not None:
        for k in CELL_KEYS:
            if k in W:
                W[k] = dataclasses.replace(W[k], idx=ro.perm[W[k].idx])
    return W


def check_outputs(art, n_sample, seed):
    """Sampled target points of every RegridResult variable against a
    float64 numpy evaluation of the same ELL weights. Returns
    {var: max rel err} and raises on any variable over TOL_REL."""
    import numpy as np

    from mpassit_tpu_torch.constants import PROJ_LC
    from mpassit_tpu_torch.weights.restagger import with_pole_rows

    cfg, grid, mesh, routing = art.cfg, art.grid, art.mesh, art.routing
    data, res = art.data, art.result
    W = run_weights(art, file_order=True)            # weight-cache hits
    rng = np.random.default_rng(seed)

    def sample(n_pts):
        return np.sort(rng.choice(n_pts, size=min(n_sample, n_pts),
                                  replace=False))

    def ell64(key, pts, src):
        return ell_f64(W[key], pts, src)

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
    # then the EDGE1/EDGE2 restagger, evaluated at sampled stagger points;
    # a periodic grid's V operator reads the pole rows after the mass
    # points, the means of mass rows 0 and ny-1
    for name, key, arr in (("U", "edge1", res.u), ("V", "edge2", res.v)):
        if arr is None:
            continue
        e = W[key]
        sp = sample(e.idx.shape[0])
        need = np.unique(np.asarray(e.idx)[sp])
        poles = e.n_src > grid.n_points
        if poles:
            edge = np.arange(grid.nx)
            need = np.union1d(need[need < grid.n_points], np.concatenate(
                [edge, edge + (grid.ny - 1) * grid.nx]))
        u = ell64("bilinear", need, data.u)
        v = ell64("bilinear", need, data.v)
        if lc:
            u, v = rot64(u, v, need)
        mass = np.zeros((grid.n_points, u.shape[1]))
        mass[need] = u if name == "U" else v
        if poles:
            mass = with_pole_rows(mass, grid.ny, grid.nx)
        ref = ell64(key, sp, mass)
        record(name, np.asarray(arr).reshape(-1, arr.shape[-1])[sp], ref)
    bad = {k: v for k, v in errs.items() if not v <= TOL_REL}
    if bad:
        raise AssertionError(f"f64 check over {TOL_REL}: {bad}")
    return errs


# ------------------------------------------------------- kernel vs plain ----

def bound_ms(nbytes, flop=0.0, peak=PEAK_F32):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over HBM_BYTES_S and the operations over
    ``peak``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flop / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _rows_of(torch, loc, W, ch=None):
    """The slab row (t * W + r) or, with the gather layout's chunk starts
    ``ch``, the source row each loc entry reads."""
    n_tiles = loc.shape[0]
    if ch is None:
        t = torch.arange(n_tiles, device=loc.device).view(-1, 1, 1)
        return t * W + loc.long()
    r = loc.long().reshape(n_tiles, -1)
    start = torch.gather(ch.long(), 1, r >> 3)
    return (start * 8 + (r & 7)).view_as(loc)


def ell_work(torch, locs, ranges, W, out_numel, ch=None, rotate=False):
    """(bytes, flop) an ELL apply must move and do on these operands: the
    output written once, each row a method reads once over the method's
    columns, loc/w once (cosa/sina with a rotation), a multiply and an add
    per term."""
    nbytes, flop = out_numel * 4, 0
    for (c0, c1), loc in zip(ranges, locs):
        rows = torch.unique(_rows_of(torch, loc, W, ch)).numel()
        nbytes += rows * (c1 - c0) * 4 + loc.numel() * 8
        flop += 2 * loc.numel() * (c1 - c0)
    n_tiles = locs[0].shape[0]
    if rotate:
        nbytes += 2 * n_tiles * 1024 * 4
    if ch is not None:
        nbytes += ch.numel() * 4
    return nbytes, flop


def csr_yardstick(torch, locs, ws, ranges, W, n_rows, dense, ch=None):
    """torch.sparse.mm over a CSR of the ELL arrays (tile-blocked target
    rows, slab or source rows as columns), one call per method range on a
    contiguous copy of its columns of ``dense``: returns the function to
    time. The CSR build and the copies happen here, outside the timing."""
    import warnings

    mats = []
    for (c0, c1), loc, w in zip(ranges, locs, ws):
        n_tiles = loc.shape[0]
        r = (torch.arange(n_tiles, device=loc.device).view(-1, 1, 1) * 1024
             + torch.arange(1024, device=loc.device).view(1, 1, -1)
             ).expand_as(loc)
        c = _rows_of(torch, loc, W, ch)
        with warnings.catch_warnings():     # sparse CSR is "beta"
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_coo_tensor(
                torch.stack([r.reshape(-1), c.reshape(-1)]), w.reshape(-1),
                (n_tiles * 1024, n_rows)).coalesce().to_sparse_csr()
        mats.append((A, dense[:, c0:c1].contiguous()))
    return lambda: [torch.sparse.mm(A, B) for A, B in mats]


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


def kernel_vs_plain(art, device, seed, launches_per_run, pack_geom,
                    streamed_launches, mercator):
    """Every kernel against its plain PyTorch version on the card at the
    main path's shapes. Returns (per-case results, {kernel: summary});
    the summary's ms/plain_ms, bound and library_ms are those of the
    kernel's first timed case. ``launches_per_run``: {kernel: launches on
    its route's main-path run}; ``pack_geom``: the column counts, rotation
    windows and group width of the streamed run's grouped pack, whose
    first and last groups are cases of their own (``launches_per_run``
    from ``streamed_launches``); ``mercator``: main_path_matrix's mercator
    run (its artifact, packed_apply's launches there, its pack's column
    counts), whose pack is a case of its own with no rotation window."""
    import numpy as np
    import torch

    from mpassit_tpu_torch.ops import gather_kernel as gk
    from mpassit_tpu_torch.ops import onehot_kernel as ok
    from mpassit_tpu_torch.ops import packed_kernel as pk
    from mpassit_tpu_torch.ops import variant_kernels as vk
    from mpassit_tpu_torch.ops.matmul_apply import (
        CH,
        PackedSlabRegridder,
        column_ranges,
        group_ranges,
        padded,
    )
    cfg, grid = art.cfg, art.grid
    W = run_weights(art)
    rng = np.random.default_rng(seed)
    nz = art.mesh.nz
    cases = []

    def run_case(kernel, name, call, plain, checksum, extra=None,
                 flop=None, work=None, library=None, launches=None):
        """``work``: (bytes, flop, peak) of the function for its bound;
        ``library``: a thunk that prepares and returns the yardstick call
        (timed, not checksum, cases only); ``launches``: the kernel's
        launches on the run whose shapes the case has, when that is not
        its route's main-path run."""
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
        nbytes, ops, peak = work
        out["bytes"], out["flop"] = nbytes, ops
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, ops, peak)
        out["launches_per_run"] = (launches_per_run.get(kernel, 0)
                                   if launches is None else launches)
        # untimed (checksum) cases: no time, so no share of the bound
        out["of_bound"] = out["library_ms"] = None
        if not checksum:
            out["ms"] = _time_ms(torch, call, 10)
            out["plain_ms"] = _time_ms(torch, plain, 5)
            if flop is not None:
                out["tflops"] = flop / out["ms"] / 1e9
            if out["ms"] > out["plain_ms"]:
                out["note"] = "kernel slower than plain"
            out["of_bound"] = out["bound_ms"] / out["ms"]
            if library is not None:
                lib_call = library()
                out["library_ms"] = _time_ms(torch, lib_call, 5)
                del lib_call
                if out["ms"] > out["library_ms"]:
                    out["note_library"] = "kernel slower than library call"
        torch.cuda.empty_cache()
        ok_ = (out["finite"] and out["max_rel_err"] <= TOL_KERNEL
               and out.get("checksum_max_rel_err", 0.0) <= 1e-5
               and out.get("equal_to_packed_apply", True)
               and out.get("equal_to_full_width", True)
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
        """Every kernel on one regridder: packed_apply, the one-hot kernel
        for each precision (onehot_apply_packed, one range per operator),
        packed_gather_apply (bit for bit
        packed_apply's output)."""
        slab, src_pad = operands(rg, C)
        locs, ws = rg._ell_dev()
        ch, locs8, ws8 = rg._gather_dev()
        nt = dict(nty=rg.nty, ntx=rg.ntx)
        packed = len(kw["ranges"]) > 1
        sums = (False, True) if packed else (False,)
        ranges, rot = kw["ranges"], bool(kw.get("rotate"))
        out_numel = rg.nty * 32 * rg.ntx * 32 * C
        slab2 = slab.view(-1, C)
        ell = ell_work(torch, locs, ranges, rg.W, out_numel, rotate=rot)
        for cs in sums:
            args = dict(**nt, **kw, with_checksum=cs)
            run_case("packed_apply", tag, lambda: pk.packed_apply(
                slab, locs, ws, **args), lambda: pk.packed_apply_plain(
                slab, locs, ws, **args), cs, work=(*ell, PEAK_F32),
                library=lambda: csr_yardstick(torch, locs, ws, ranges, rg.W,
                                              slab2.shape[0], slab2))
        As = rg.As
        dense_bytes = (out_numel + slab.numel()
                       + sum(A.numel() for A in As)) * 4

        def bmm(As=As):
            """torch.bmm of each method's A^T with its columns of the slab
            (f32, TF32 off)."""
            mats = [(A.transpose(1, 2), slab[:, :, c0:c1].contiguous())
                    for A, (c0, c1) in zip(As, ranges)]
            return lambda: [torch.bmm(A, S) for A, S in mats]
        for prec in ("split6_bf16", "split_bf16", "highest"):
            plan = ok.launch_plan(rg.n_tiles, rg.W, C, kw["ranges"],
                                  kw.get("rotate", ()), prec)
            terms = {"terms": plan.terms, "K": plan.K}
            work = (dense_bytes, plan.terms * 2 * rg.n_tiles * 1024 * rg.W
                    * ranges[-1][1], PEAK_BF16)
            for cs in sums:
                args = dict(**nt, **kw, with_checksum=cs, precision=prec)
                run_case(
                    "onehot_apply_packed", f"{tag}_{prec}",
                    lambda: ok.onehot_apply_packed(As, slab, **args),
                    lambda: ok.onehot_apply_packed_plain(As, slab, **args),
                    cs, extra=lambda got: terms, flop=plan.flop, work=work,
                    library=bmm)
        del As, bmm
        rg._As = None
        gat = ell_work(torch, locs8, ranges, rg.W8, out_numel, ch=ch,
                       rotate=rot)
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
                     extra=same, work=(*gat, PEAK_F32),
                     library=lambda: csr_yardstick(
                         torch, locs8, ws8, ranges, rg.W8, src_pad.shape[0],
                         src_pad, ch=ch))

    def group_cases(geom):
        """packed_apply and onehot_apply_packed (split6_bf16) on the first
        group (with the rotation) and the last group (the methods' tails
        and the zero tail) of the streamed run's grouped pack: each against
        its plain version, and bit for bit the same columns of the kernel's
        own full-width output on the same slab."""
        keys = ("bilinear", "nearest", "conserve")
        if len(geom["cols"]) != len(keys):
            raise AssertionError(f"unexpected pack {geom}")
        rotate = tuple(map(tuple, geom["rotate"]))
        gp = PackedSlabRegridder([W[k] for k in keys], device,
                                 rotation=((grid.cosa, grid.sina)
                                           if rotate else None),
                                 cache_dir=cfg.weights_cache_dir)
        ranges = column_ranges(geom["cols"])
        gw, prec = geom["gw"], "split6_bf16"
        Cp = padded(ranges[-1][1])
        slab, _ = operands(gp, Cp)
        locs, ws = gp._ell_dev()
        As = gp.As
        nt = dict(nty=gp.nty, ntx=gp.ntx)
        rot = dict(rotate=rotate, cosa=gp._cosa_t, sina=gp._sina_t)
        full = {"packed_apply": pk.packed_apply(
                    slab, locs, ws, ranges=ranges, **nt, **rot),
                "onehot_apply_packed": ok.onehot_apply_packed(
                    As, slab, ranges=ranges, precision=prec, **nt,
                    **rot)}
        for g in (0, Cp - gw):
            sub, ms = group_ranges(ranges, g, gw)
            kw = dict(ranges=sub, **nt, **(rot if g == 0 else {}))
            sg = slab[:, :, g:g + gw].contiguous()
            lg, wg, Ag = ([a[m] for m in ms] for a in (locs, ws, As))
            tag = (f"group{g // gw}_of{-(-Cp // gw)}_gw{gw}"
                   + ("_rot" if g == 0 else "_tail"))
            out_numel = gp.nty * 32 * gp.ntx * 32 * gw
            sg2 = sg.view(-1, gw)

            def same(kernel, g=g):
                return lambda got: {"equal_to_full_width": bool(
                    torch.equal(got, full[kernel][:, :, g:g + gw])),
                    "columns": [g, g + gw], "ranges": list(sub)}
            run_case("packed_apply", tag,
                     lambda: pk.packed_apply(sg, lg, wg, **kw),
                     lambda: pk.packed_apply_plain(sg, lg, wg, **kw), False,
                     extra=same("packed_apply"),
                     work=(*ell_work(torch, lg, sub, gp.W, out_numel,
                                     rotate=g == 0), PEAK_F32),
                     library=lambda: csr_yardstick(torch, lg, wg, sub, gp.W,
                                                   sg2.shape[0], sg2),
                     launches=streamed_launches["packed_apply"])
            plan = ok.launch_plan(gp.n_tiles, gp.W, gw, sub,
                                  kw.get("rotate", ()), prec)

            def bmm(Ag=Ag, sub=sub, sg=sg):
                mats = [(A.transpose(1, 2), sg[:, :, c0:c1].contiguous())
                        for A, (c0, c1) in zip(Ag, sub)]
                return lambda: [torch.bmm(A, S) for A, S in mats]
            run_case("onehot_apply_packed", f"{tag}_{prec}",
                     lambda: ok.onehot_apply_packed(Ag, sg, precision=prec,
                                                    **kw),
                     lambda: ok.onehot_apply_packed_plain(
                         Ag, sg, precision=prec, **kw), False,
                     extra=same("onehot_apply_packed"), flop=plan.flop,
                     work=((out_numel + sg.numel()
                            + sum(A.numel() for A in Ag)) * 4,
                           plan.terms * 2 * gp.n_tiles * 1024 * gp.W
                           * sub[-1][1], PEAK_BF16),
                     library=bmm,
                     launches=streamed_launches["onehot_apply_packed"])
            del sg, sg2, lg, wg, Ag
        del gp, slab, locs, ws, As, full

    def mercator_case(m_art, m_launches, m_cols):
        """packed_apply on the mercator target's own pack (its weights
        from the cache, its column counts): the main path's kernel with no
        rotation window, off Lambert."""
        keys = ("bilinear", "nearest", "conserve")
        if len(m_cols) != len(keys):
            raise AssertionError(f"unexpected mercator pack {m_cols}")
        mW = run_weights(m_art)
        mp = PackedSlabRegridder([mW[k] for k in keys], device,
                                 cache_dir=m_art.cfg.weights_cache_dir)
        if mp._cosa_t is not None:
            raise AssertionError("mercator pack has a rotation grid")
        Cp = padded(sum(m_cols))
        slab, _ = operands(mp, Cp)
        locs, ws = mp._ell_dev()
        kw = dict(ranges=column_ranges(m_cols), nty=mp.nty, ntx=mp.ntx)
        slab2 = slab.view(-1, Cp)
        run_case("packed_apply",
                 f"packed_mercator_{m_art.grid.nx}x{m_art.grid.ny}"
                 f"_cp{Cp}_norot",
                 lambda: pk.packed_apply(slab, locs, ws, **kw),
                 lambda: pk.packed_apply_plain(slab, locs, ws, **kw), False,
                 extra=lambda got: {"cols": list(m_cols), "W": mp.W,
                                    "ranges": list(kw["ranges"])},
                 work=(*ell_work(torch, locs, kw["ranges"], mp.W,
                                 mp.nty * 32 * mp.ntx * 32 * Cp),
                       PEAK_F32),
                 library=lambda: csr_yardstick(torch, locs, ws,
                                               kw["ranges"], mp.W,
                                               slab2.shape[0], slab2),
                 launches=m_launches)
        del mp, slab, slab2, locs, ws

    # the packed bilinear+nearest+conserve operator at Cp = 1024 with the
    # mass-wind window (0, nz, nz) first, like the main path's pack
    cols = {"bilinear": 1024 - 2 * 16, "nearest": 16, "conserve": 16}
    pack = PackedSlabRegridder(
        [W[k] for k in cols], device, rotation=(grid.cosa, grid.sina),
        cache_dir=cfg.weights_cache_dir)
    cover(pack, 1024, dict(ranges=column_ranges(cols.values()),
                           rotate=((0, nz, nz),), cosa=pack._cosa_t,
                           sina=pack._sina_t),
          "packed_conus_cp1024_rot")
    del pack
    torch.cuda.empty_cache()
    group_cases(pack_geom)
    torch.cuda.empty_cache()
    mercator_case(*mercator)
    torch.cuda.empty_cache()
    edge = PackedSlabRegridder([W["edge1"]], device,
                               cache_dir=cfg.weights_cache_dir)
    cover(edge, 128, dict(ranges=((0, 128),)), "edge1_restagger")
    del edge
    torch.cuda.empty_cache()

    # the ELL-built split_bf16 variants on the bilinear operator at 512
    # columns, the shape of the kernel_variants phase
    bil = PackedSlabRegridder([W["bilinear"]], device,
                              precision="split_bf16",
                              cache_dir=cfg.weights_cache_dir)
    slab, _ = operands(bil, 512)
    (loc,), (wt,) = bil._ell_dev()
    nt = dict(nty=bil.nty, ntx=bil.ntx)
    vnum = bil.nty * 32 * bil.ntx * 32 * 512
    vbytes, _ = ell_work(torch, [loc], ((0, 512),), bil.W, vnum)
    # split_bf16: three bf16 products over the dense one-hot A; the
    # kernels' tensor-core FLOP at the padded K for their TFLOP/s
    vwork = (vbytes, 3 * 2 * bil.n_tiles * 1024 * bil.W * 512, PEAK_BF16)
    vflop = vk.ell_split_plan(bil.n_tiles, bil.W, 512, int(loc.shape[1]),
                              "v1").flop
    slab2 = slab.view(-1, 512)

    def vlib():
        return csr_yardstick(torch, [loc], [wt], ((0, 512),), bil.W,
                             slab2.shape[0], slab2)

    def vs_v2(got):
        """v1's output against v2's at each CC: the same products in the
        same order, so bit for bit."""
        rel, same = 0.0, True
        for cc in vk.V2_CC:
            v2 = vk.ell_split_apply_v2(loc, wt, slab, CC=cc, **nt)
            rel = max(rel, float((got - v2).abs().max())
                      / max(float(got.abs().max()), 1e-30))
            same &= bool(torch.equal(got, v2))
            del v2
        return {"W": bil.W, "vs_v2_max_rel_err": rel,
                "vs_v2_bit_identical": same, "vs_v2_ok": same}
    run_case("ell_split_apply_v1", "bilinear_cp512",
             lambda: vk.ell_split_apply_v1(loc, wt, slab, **nt),
             lambda: vk.ell_split_apply_v1_plain(loc, wt, slab, **nt), False,
             extra=vs_v2, flop=vflop, work=vwork, library=vlib)
    for cc in vk.V2_CC:
        run_case("ell_split_apply_v2", f"bilinear_cp512_cc{cc}",
                 lambda: vk.ell_split_apply_v2(loc, wt, slab, CC=cc, **nt),
                 lambda: vk.ell_split_apply_v2_plain(loc, wt, slab, **nt),
                 False, flop=vflop, work=vwork, library=vlib)
    del bil, slab, slab2, loc, wt
    torch.cuda.empty_cache()
    summary = {}
    for c in cases:
        s = summary.setdefault(c["kernel"], {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], c["max_abs_err"])
        if "ms" in c and "ms" not in s:
            s.update({k: c[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                     ms_case=c["case"])
    return cases, summary


# ------------------------------------------------------ write wall ----

def write_wall_phase(device, nty, ntx, packed_ms, onehot_ms, seed):
    """The store-only kernel at the packed output shape (Cp = 1024): its
    launches counted alone, its time, its whole output against the plain
    version bit for bit, and the packed kernels' times (packed_apply,
    onehot_apply_packed at split6_bf16) as multiples of it. Returns (the
    phase's launches, the kernel's summary)."""
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
    del ref
    library_ms = _time_ms(torch, lambda: got.fill_(1.0), 10)
    del got
    torch.cuda.empty_cache()
    plain_ms = _time_ms(torch, lambda: ww.write_wall_plain(row, nty=nty,
                                                          ntx=ntx), 5)
    nbytes = nty * 32 * ntx * 32 * Cp * 4
    bound, bound_by = bound_ms(nbytes)
    rec = {"phase": "write_wall", "shape": [nty * 32, ntx * 32, Cp],
           "out_bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": bound_by, "of_bound": bound / ms,
           "library_ms": library_ms, "library": "Tensor.fill_",
           "write_gb_per_s": nbytes / ms / 1e6,
           "plain_gb_per_s": nbytes / plain_ms / 1e6,
           "bit_identical_to_plain": equal, "finite": finite,
           "packed_apply_ms": packed_ms,
           "packed_apply_over_wall": packed_ms / ms,
           "packed_apply_share_of_write_rate": ms / packed_ms,
           "onehot_apply_packed_ms": onehot_ms,
           "onehot_apply_packed_over_wall": onehot_ms / ms,
           "launches": launches, "plain_calls": plain_calls}
    rec["ok"] = equal and finite and _owed_only(launches, plain_calls,
                                                ("write_wall",))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"write_wall phase failed: {rec}")
    return launches, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": library_ms,
                      "ms_case": f"packed_conus_cp{Cp}"}


def kernel_variants_phase(art, device, seed, reduced):
    """The kernel-variants tool in-process on this mesh's bilinear
    operator (weights from the run's cache) at the full target width and
    512 columns. Returns the phase's launches."""
    from mpassit_tpu_torch.tools.kernel_variants import run_variants

    W = run_weights(art)
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


# ---------------------------------------------------------------- build ----

def ptxas_summary(log):
    """Per kernel of a -Xptxas -v log: registers, spills, stack and static
    shared memory."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
        elif cur is not None:
            for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill st"),
                             ("spill_load_bytes", r"(\d+) bytes spill lo"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m.group(1))
    return out


def sass_counts(so, source):
    """Tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) and f32
    FMAs in the SASS of a built library, by cuobjdump beside nvcc; None
    without it."""
    from mpassit_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc(source)), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    ops = [ln.split()[1].split(".")[0] for ln in sass.splitlines()
           if ln.strip().startswith("/*") and len(ln.split()) > 1]
    return {k: sum(op == k for op in ops) for k in ("HGMMA", "HMMA", "FFMA")}


# ----------------------------------------------------------------- main ----

#: kernel -> (source, the TPU kernels it replaces); onehot_apply_packed
#: stands for fused_apply_packed with As= and, at one range, fused_apply
KERNELS = {
    "packed_apply": ("mpassit_tpu_torch/csrc/packed_apply.cu",
                     "mpassit_tpu/ops/pallas_matmul.py:482"),
    "onehot_apply_packed": ("mpassit_tpu_torch/csrc/onehot_apply.cu",
                            "mpassit_tpu/ops/pallas_matmul.py:482,119"),
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
            "packed_gather_apply": "gather",
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


def expected_launches(route, calls):
    """Kernel launches the route owes for the recorded applies
    ([kind, Cp, gw]), union or one operator alike: one per apply, or one
    per column group of the width gw the grouped apply was called with;
    one gather launch per apply on the gather route, which is never
    grouped."""
    e = dict.fromkeys(KERNELS, 0)
    for _, Cp, gw in calls:
        n = -(-Cp // gw) if gw else 1
        if route == "onehot":
            e["onehot_apply_packed"] += n
        elif route == "gather":
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
    a, b = _result_arrays(got), _result_arrays(ref)
    if list(a) != list(b):
        raise AssertionError(f"result variables differ: {list(a)} {list(b)}")
    return compare_results_arrays(a, b)


def compare_results_arrays(a, b):
    """compare_results on {name: array} maps (``_result_arrays``')."""
    import numpy as np

    if sorted(a) != sorted(b):
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


class StripRecorder:
    """Stands in for ``io/wrf_writer.StreamingWriter`` (same constructor,
    ``open``/``put``/``finish``/``stats``) where no NetCDF4 file can be
    written. It writes nothing and keeps no second copy of the output:
    each put is checked as it arrives, bit for bit against ``ref`` (var
    -> the default route's RegridResult array) where the var has one, else
    sampled at the flat target points ``pts`` into ``sampled``; each level
    of each var of the stream plan is counted, to arrive exactly once."""

    def __init__(self, ref, pts, path, cfg, grid, data, plan, nz, nzp1,
                 nsoil, zs):
        import numpy as np

        self.ref, self.pts = ref, pts
        nlev = {"diag2d": 1, "cons2d": 1, "patch2d": 1, "nstd2d": 1,
                "diag3d": nz, "soil": nsoil, "nz3d": nz, "nzp13d": nzp1,
                "vert3d": nz}
        self.count = {"HGT": np.zeros(1, int)}
        for cat, k in nlev.items():
            for name, *_ in plan.get(cat, []):
                self.count[name] = np.zeros(k, int)
        for var, flag in (("U", "do_u"), ("V", "do_v")):
            if plan.get(flag):
                self.count[var] = np.zeros(nz, int)
        self.sampled, self.checked = {}, set()
        self.mismatched, self.unexpected = [], []
        self.stats = {"t_write_s": 0.0, "blocks": 0}

    def open(self):
        return self

    def put(self, var, lev0, block):
        import numpy as np

        t0 = time.perf_counter()
        block = np.asarray(block)
        k = 1 if block.ndim == 2 else block.shape[2]
        self.stats["blocks"] += 1
        if var not in self.count:
            self.unexpected.append(var)
            return
        self.count[var][lev0:lev0 + k] += 1
        ref = self.ref.get(var)
        if ref is not None:
            r = ref if ref.ndim == 2 else ref[:, :, lev0:lev0 + k]
            if not np.array_equal(block, r):
                self.mismatched.append([var, lev0, k])
            self.checked.add(var)
        else:
            s = self.sampled.setdefault(var, np.full(
                (len(self.pts), len(self.count[var])), np.nan))
            s[:, lev0:lev0 + k] = block.reshape(-1, k)[self.pts]
        self.stats["t_write_s"] += time.perf_counter() - t0

    def finish(self):
        pass

    def missing(self):
        """var -> the levels that did not arrive exactly once."""
        return {v: [int(i) for i in (c != 1).nonzero()[0]]
                for v, c in self.count.items() if (c != 1).any()}


def interp_split(art, split):
    """Where interp_data went: the run's own ``apply.*`` and
    ``weights.pack`` stages (its spans, host clock; none synchronizes, so
    a span includes what it waits for), with ``split`` (the sharded
    phase's band gather)."""
    stages = art.timings.stages if art is not None else {}
    return {**{k: v for k, v in stages.items()
               if k.startswith("apply.") or k == "weights.pack"}, **split}


def streamed_phase(pipeline, nml, default_art, device, seed, reduced,
                   default_peak_gb, arts, calls, split, pack_geom):
    """main_path_streamed: the CLI on ``nml`` (stream_output = .true., the
    vorticity varlists) with MPASSIT_DEVICE_BUDGET_GB=4 on the default
    route, so the packed apply runs in column groups, a StripRecorder
    standing in for the writer. Fails unless every streamed variable is
    bit for bit the default route's, the vertex field is within TOL_REL of
    a float64 evaluation at sampled points, every var and level arrived
    once, the launches are those owed (the groups read from the
    regridder's own call), no plain version ran, and the peak device
    memory is below the default route's and within BUDGET_GB. Returns the
    phase's launches."""
    import numpy as np
    import torch

    from mpassit_tpu_torch.ops import packed_kernel as pk

    res, grid = default_art.result, default_art.grid
    ref = {k.split(".", 1)[1]: v for k, v in _result_arrays(res).items()
           if "." in k}
    ref.update(HGT=res.hgt, U=res.u, V=res.v)
    pts = np.sort(np.random.default_rng(seed).choice(
        grid.n_points, size=min(4000, grid.n_points), replace=False))
    made = []

    def recorder(*a):
        made.append(StripRecorder(ref, pts, *a))
        return made[-1]

    writer_cls = pipeline.StreamingWriter
    pipeline.StreamingWriter = recorder
    os.environ["MPASSIT_DEVICE_BUDGET_GB"] = str(BUDGET_GB)
    _zero_counters()
    t0 = time.perf_counter()
    try:
        rc = pipeline.main([nml])
    finally:
        pipeline.StreamingWriter = writer_cls
        del os.environ["MPASSIT_DEVICE_BUDGET_GB"]
    t_main = time.perf_counter() - t0
    launches, plain_calls = _counters()
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    if rc != 0 or not arts or len(made) != 1:
        raise SystemExit(f"main_path_streamed failed: rc={rc}")
    art, rec = arts[0], made[0]
    art.regridders.clear()
    expected = expected_launches("ell", calls)
    # the vertex-located fields against a float64 evaluation
    W = run_weights(art)
    vert = {}
    for s in art.routing.vert_3d:
        want = ell_f64(W["vertex"], pts, art.data.fields[s.in_name])
        got = rec.sampled.get(s.out_name)
        vert[s.out_name] = (float(np.abs(got - want).max()
                                  / max(float(np.abs(want).max()), 1e-30))
                            if got is not None else None)
    packed = [c for c in calls if c[0] == "packed"]
    line = {
        "phase": "main_path_streamed", "rc": rc, "t_s": t_main,
        "config": {"namelist": os.path.basename(nml),
                   "stream_output": True,
                   "MPASSIT_DEVICE_BUDGET_GB": BUDGET_GB,
                   "route": "default",
                   "varlists": "parm/ + histlist_3d 'vorticity VORT'"},
        "stages_s": art.timings.stages,
        "write_to_file_is": "StripRecorder's open, puts (each checked "
                            "against the default route) and finish; no "
                            "file is written",
        "interp_data_split_s": interp_split(art, split),
        "group_width": pack_geom.get("gw", 0),
        "n_groups": sum(-(-c[1] // c[2]) if c[2] else 1 for c in packed),
        "pack_cols": pack_geom.get("cols"), "puts": rec.stats["blocks"],
        # the groups' launch plans beside the earlier phases': an
        # eviction would show as currsize at maxsize
        "ell_plan_cache": pk._plan_on.cache_info()._asdict(),
        "launches": launches, "expected_launches": expected,
        "applies": calls, "plain_calls": plain_calls,
        "peak_device_gb": peak, "peak_within_budget": peak <= BUDGET_GB,
        "default_route_peak_device_gb": default_peak_gb,
        "vars_bit_identical_to_default": len(rec.checked),
        "vars_streamed": len(rec.count), "mismatched": rec.mismatched[:20],
        "missing_or_repeated": rec.missing(), "unexpected": rec.unexpected,
        "vertex_max_rel_err": vert, "tol_rel": TOL_REL,
        "reduced": reduced + ["ncells 655362 < 2600000 "
                              "(tools/bench_production.py)"]}
    line["ok"] = ok_ = bool(
        launches == expected and launches["packed_apply"] > 0
        and pack_geom.get("gw") and not any(plain_calls.values())
        and not rec.mismatched and not line["missing_or_repeated"]
        and not rec.unexpected and vert
        and all(e is not None and e <= TOL_REL for e in vert.values())
        and len(rec.checked) + len(vert) == len(rec.count)
        and peak < default_peak_gb and peak <= BUDGET_GB)
    emit(line)
    if not ok_:
        raise SystemExit("main_path_streamed failed its checks")
    return launches


def sharded_phase(pipeline, nml, nml_sharded, default_art, device, seed,
                  reduced, arts, calls, split):
    """main_path_sharded: the CLI once unsharded on the default route
    (weights and pack caches warm: the yardstick of this call), then on
    each namelist of SHARDED (n_device_shards = -1) as a world of one
    process over NCCL, started by ``pipeline.main`` from the MPASSIT_*
    variables and destroyed when it returns. replicate must be bit for bit
    the default route's result with packed_apply's 3 launches and no
    plain call; ring and allgather (plain torch engines, no kernel) within
    TOL_REL of the float64 evaluation. Each line has interp_data and its
    split (the band gather bracketed by synchronizes as
    ``band_gather_s``), the peak device memory and the unsharded run's.
    Returns the replicate run's launches."""
    import gc

    import torch

    from mpassit_tpu_torch.ops import matmul_apply
    from mpassit_tpu_torch.tools.dryrun_multichip import free_port

    gather = matmul_apply.gather_bands

    def timed_gather(*a, **kw):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        r = gather(*a, **kw)
        torch.cuda.synchronize(device)
        split["band_gather_s"] = (split.get("band_gather_s", 0.0)
                                  + time.perf_counter() - t)
        return r

    def one_run(path, world):
        arts.clear()
        calls.clear()
        split.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        env = ({"MPASSIT_COORDINATOR": f"tcp://localhost:{free_port()}",
                "MPASSIT_NUM_PROCESSES": str(world),
                "MPASSIT_PROCESS_ID": "0"} if world else {})
        os.environ.update(env)
        _zero_counters()
        t0 = time.perf_counter()
        try:
            rc = pipeline.main([path])
        finally:
            for k in env:
                del os.environ[k]
        t_main = time.perf_counter() - t0
        launches, plain_calls = _counters()
        if rc != 0 or not arts:
            raise SystemExit(f"main_path_sharded: {path} failed: rc={rc}")
        if torch.distributed.is_initialized():
            raise SystemExit("main_path_sharded: the process group outlived "
                             "the run")
        art = arts[0]
        art.regridders.clear()
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        return art, {"rc": rc, "t_s": t_main, "stages_s": art.timings.stages,
                     "interp_data_split_s": interp_split(art, split),
                     "launches": launches,
                     "expected_launches": expected_launches("ell", calls),
                     "applies": list(calls), "plain_calls": plain_calls,
                     "peak_device_gb": peak}

    base_art, base = one_run(nml, 0)
    base_art.result = base_art.data = None
    del base_art
    matmul_apply.gather_bands = timed_gather
    launches = None
    try:
        for decomp, path in zip(SHARDED, nml_sharded):
            art, line = one_run(path, 1)
            line = {"phase": "main_path_sharded", "source_decomp": decomp,
                    "n_device_shards": -1, "world": 1,
                    "backend": "nccl" if device.type == "cuda" else "gloo",
                    **line, "unsharded": {
                        k: base[k] for k in ("stages_s",
                                             "interp_data_split_s",
                                             "launches", "peak_device_gb")},
                    "reduced": reduced}
            line["interp_data_vs_unsharded"] = (
                line["stages_s"]["interp_data"]
                / base["stages_s"]["interp_data"])
            line["vs_default_route"] = diff = compare_results(
                art.result, default_art.result)
            if decomp == "replicate":
                launches = line["launches"]
                ok_ = (diff["bit_identical"]
                       and launches == line["expected_launches"]
                       and launches["packed_apply"] == 3
                       and not any(line["plain_calls"].values()))
            else:
                try:
                    errs = check_outputs(art, 4000, seed)
                except AssertionError as e:
                    errs = {"error": str(e)[:500]}
                line["tol_rel"] = TOL_REL
                line["per_var_max_rel_err"] = errs
                ok_ = (all(isinstance(v, float) and v <= TOL_REL
                           for v in errs.values())
                       and not any(line["launches"].values())
                       and not any(line["plain_calls"].values()))
                if ok_:
                    line["max_rel_err"] = max(errs.values())
            line["ok"] = bool(ok_)
            art.result = art.data = None
            emit(line)
            if not ok_:
                raise SystemExit(f"main_path_sharded ({decomp}) failed its "
                                 "checks")
    finally:
        matmul_apply.gather_bands = gather
    return launches


#: one rank of main_path_sharded_ranks: the CLI function with the file
#: write left out to keep the smoke run's time (the port writes the file
#: without h5py; main_path_written times that write), its stages, wall and
#: peak device memory printed as the last line of its output
RANK_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from mpassit_tpu_torch.run import pipeline as p
p.write_output = lambda *a: None
arts, run = [], p.run_pipeline
p.run_pipeline = lambda *a, **kw: arts.append(run(*a, **kw)) or arts[-1]
t0 = time.perf_counter()
rc = p.main([sys.argv[2]])
print(json.dumps({"rc": rc, "t_s": time.perf_counter() - t0,
                  "stages_s": arts[0].timings.stages if arts else None,
                  "peak_device_gb": (torch.cuda.max_memory_allocated() / 1e9
                                     if torch.cuda.is_available() else None)}))
"""


def _launch_ranks(nml, world, dump, timeout):
    """``world`` processes of RANK_CHILD on ``nml`` (one process without
    the MPASSIT_* variables when ``world`` is 0), each in a session of its
    own, all killed past ``timeout`` s; rank 0 dumps its results to
    ``dump``. Returns each process's last line."""
    import signal

    from mpassit_tpu_torch.tools.dryrun_multichip import free_port

    port = free_port()
    procs = []
    for rank in range(max(world, 1)):
        env = dict(os.environ, MPASSIT_DUMP_RESULT=dump,
                   PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        if world:
            env.update(MPASSIT_COORDINATOR=f"tcp://localhost:{port}",
                       MPASSIT_NUM_PROCESSES=str(world),
                       MPASSIT_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD, HERE, nml], cwd=WORK, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(
                timeout=max(1, deadline - time.monotonic()))
            lines = out.strip().splitlines()
            outs.append(json.loads(lines[-1]) if lines
                        else {"rc": proc.returncode, "stderr": err[-1500:]})
    except subprocess.TimeoutExpired:
        raise SystemExit(f"main_path_sharded_ranks: over {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return outs


def ranks_phase(nml, nml_sharded, default_art, world, timeout=600):
    """main_path_sharded_ranks: with ``world`` >= 2 cards, the CLI as
    ``world`` processes, one card each, over NCCL on the sharded
    namelists of replicate and ring (the shipped varlists at the full smoke
    width), beside one unsharded process on the shipped namelist (caches
    warm): replicate must be bit for bit the default route's result, ring
    within TOL_ROUTE of each variable's largest magnitude of it (its sums
    split over source blocks); rank 0's stages and every rank's wall and
    peak device memory. With fewer cards, a line saying it was not run."""
    import gc

    import numpy as np

    if world < 2:
        emit({"phase": "main_path_sharded_ranks", "run": False,
              "why": f"{world} CUDA device on this machine; several ranks "
                     "need several cards"})
        return
    dump = os.path.join(WORK, "ranks_result.npz")
    ref = _result_arrays(default_art.result)
    base = None
    for decomp, path in (("unsharded", nml),) + tuple(
            zip(SHARDED[:2], nml_sharded[:2])):
        if os.path.exists(dump):
            os.remove(dump)
        outs = _launch_ranks(path, 0 if decomp == "unsharded" else world,
                             dump, timeout)
        line = {"phase": "main_path_sharded_ranks", "source_decomp": decomp,
                "world": 0 if decomp == "unsharded" else world,
                "rc": [o.get("rc") for o in outs],
                "t_s": [o.get("t_s") for o in outs],
                "peak_device_gb": [o.get("peak_device_gb") for o in outs],
                "stages_s": outs[0].get("stages_s"),
                "errors": [o["stderr"] for o in outs if "stderr" in o]}
        ok_ = all(o.get("rc") == 0 for o in outs) and os.path.exists(dump)
        if ok_:
            with np.load(dump) as z:
                got = {k: z[k] for k in z.files}
            line["vs_default_route"] = diff = compare_results_arrays(got, ref)
            ok_ = (diff["bit_identical"] if decomp != "ring"
                   else diff["max_rel_diff"] <= TOL_ROUTE)
            del got
            gc.collect()
        if base is None:
            base = line["stages_s"] or {}
        elif line["stages_s"]:
            line["interp_data_vs_unsharded"] = (
                line["stages_s"]["interp_data"] / base["interp_data"])
        line["ok"] = bool(ok_)
        emit(line)
        if not ok_:
            raise SystemExit(f"main_path_sharded_ranks ({decomp}) failed")
    os.remove(dump)


#: packed_apply's kernel in a trace (names come demangled): ell_apply.cuh's
#: template on the slab rows
PACKED_SYMBOL = "ell_apply_kernel<SlabRows"


def profiled_phase(pipeline, nml, default_art, arts, calls, reduced):
    """main_path_profiled: the CLI on the default route (weights cache
    warm) once unprofiled, for the profiler's overhead, then with
    MPASSIT_PROFILE set. Fails unless every result of the profiled run is
    bit for bit the unprofiled default run's, and the trace holds
    packed_apply's kernel as often as its counter counts, the launches
    owed, on the stream of torch's own kernels. Returns the profiled
    run's launches."""
    import gc

    import torch

    from mpassit_tpu_torch.tools import trace_summary as ts

    prof_dir = os.path.join(WORK, "profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    arts.clear()
    if pipeline.main([nml]) != 0 or not arts:
        raise SystemExit("main_path_profiled: the unprofiled run failed")
    unprofiled = arts[0].timings.stages
    arts.clear()
    calls.clear()
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["MPASSIT_PROFILE"] = prof_dir
    _zero_counters()
    t0 = time.perf_counter()
    try:
        rc = pipeline.main([nml])
    finally:
        del os.environ["MPASSIT_PROFILE"]
    t_main = time.perf_counter() - t0
    launches, plain_calls = _counters()
    if rc != 0 or not arts:
        raise SystemExit(f"main_path_profiled failed: rc={rc}")
    art = arts[0]
    art.regridders.clear()
    expected = expected_launches("ell", calls)
    # the directory was emptied before the run: its one trace
    (path,) = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir)]
    t0 = time.perf_counter()
    events = ts.load_events(path)
    summ = ts.summarize(events)
    t_summary = time.perf_counter() - t0
    kernels = [e for _, _, e in ts.device_events(events)
               if e.get("cat") == "kernel"]
    ours = [e for e in kernels if PACKED_SYMBOL in e["name"]]
    mine = {id(e) for e in ours}
    streams = sorted({str(e.get("args", {}).get("stream")) for e in ours})
    torch_streams = sorted({str(e.get("args", {}).get("stream"))
                            for e in kernels if id(e) not in mine})
    diff = compare_results(art.result, default_art.result)
    stages = art.timings.stages
    run, interp = summ["run"], summ["stages"].get("interp_data", {})

    def short(ops):
        """Device operations with their names cut to 100 characters (the
        trace keeps them whole)."""
        return [{**o, "name": o["name"][:100]} for o in ops or []]
    line = {
        "phase": "main_path_profiled", "rc": rc, "t_s": t_main,
        "trace": os.path.relpath(path, HERE),
        "trace_bytes": os.path.getsize(path), "summary_s": t_summary,
        "stages_s": stages,
        "unprofiled_stages_s": unprofiled,
        "interp_data_unprofiled_s": unprofiled["interp_data"],
        "profiler_overhead_interp_data": (stages["interp_data"]
                                          / unprofiled["interp_data"] - 1),
        "run_idle_share": run["idle_share"], "run_window_s": run["window_s"],
        "run_busy_s": run["busy_s"],
        "interp_data_idle_share": interp.get("idle_share"),
        "interp_data_busy_s": interp.get("busy_s"),
        "stage_idle_share": {k: v["idle_share"]
                             for k, v in summ["stages"].items()},
        "run_top_ops": short(run["top_ops"]),
        "run_longest_gaps": run["longest_gaps"],
        "interp_data_top_ops": short(interp.get("top_ops")),
        "interp_data_longest_gaps": interp.get("longest_gaps"),
        "device_events": summ["device_events"],
        "packed_apply_in_trace": len(ours),
        "packed_apply_names": sorted({e["name"][:80] for e in ours}),
        "packed_apply_streams": streams, "torch_kernel_streams": torch_streams,
        "launches": launches, "expected_launches": expected,
        "plain_calls": plain_calls, "vs_default_route": diff,
        "reduced": reduced}
    line["ok"] = ok_ = bool(
        diff["bit_identical"] and launches == expected
        and not any(plain_calls.values())
        and len(ours) == launches["packed_apply"] == expected["packed_apply"]
        and torch_streams and set(streams) <= set(torch_streams))
    emit(line)
    art.result = art.data = None
    arts.clear()
    if not ok_:
        raise SystemExit("main_path_profiled failed its checks")
    return launches


def _writer_digests(art):
    """What the in-memory writer would store from ``art``'s result: the
    production tool's digest stand-in in place of the NetCDF4 file. Returns
    the digest map and its data bytes."""
    from mpassit_tpu_torch.io import wrf_writer
    from mpassit_tpu_torch.tools.bench_production import DigestFile, digest_map

    sink, orig = {}, wrf_writer.NetCDF4File
    wrf_writer.NetCDF4File = lambda path, mode="w": DigestFile(sink, path,
                                                               mode)
    try:
        wrf_writer.write_output(art.cfg.output_file, art.cfg, art.grid,
                                art.data, art.result)
    finally:
        wrf_writer.NetCDF4File = orig
    return digest_map(sink), sum(sink["bytes"].values())


#: ``- <stage>: <seconds>s``, the CLI's log line of each Timings stage
STAGE_LINE = r"^- (\w+): ([0-9.]+)s$"


def written_phase(pipeline, nml, default_art, arts, smi, reduced,
                  timeout=600):
    """main_path_written: the normal entry point, ``python -m
    mpassit_tpu_torch <namelist>``, as a child process on the shipped
    namelist (weights cache warm, no write_output patched): its NetCDF4
    file is read back through ``open_dataset`` and every variable, level by
    level, must be bit for bit what the writer would store from
    main_path's result (the digest stand-in's map). With less than twice
    the file's bytes free in the run's directory it runs at a reduced
    target grid of the same extent, its reference an in-process run of
    that namelist, listed in ``reduced``."""
    import re
    import signal

    from mpassit_tpu_torch.io.nc4 import open_dataset
    from mpassit_tpu_torch.tools.bench_production import (compare_digests,
                                                          digest_file)

    t_phase = time.perf_counter()
    ref, nbytes = _writer_digests(default_art)
    t_ref = time.perf_counter() - t_phase
    free = shutil.disk_usage(WORK).free
    cut = []
    if free < 2 * nbytes:
        scale = (free / (2.5 * nbytes)) ** 0.5
        grid = default_art.grid
        nx, ny = max(8, int(grid.nx * scale)), max(8, int(grid.ny * scale))
        with open(nml) as f:
            text = f.read()
        for key, val in (("nx", nx), ("ny", ny), ("dx", default_art.cfg.dx
                                                    * grid.nx / nx),
                         ("dy", default_art.cfg.dx * grid.nx / nx)):
            text = re.sub(rf"(?m)^ {key} = .*$", f" {key} = {val}", text)
        nml = os.path.join(WORK, "namelist_written.input")
        with open(nml, "w") as f:
            f.write(text)
        arts.clear()
        if pipeline.main([nml]) != 0 or not arts:
            raise SystemExit("main_path_written: the reduced reference run "
                             "failed")
        ref, nbytes = _writer_digests(arts[0])
        arts.clear()
        cut = [f"target grid {nx}x{ny} < {grid.nx}x{grid.ny}: {free} bytes "
               f"free < 2 x {nbytes}"]
    out = default_art.cfg.output_file
    if os.path.exists(out):
        os.remove(out)
    env = dict(os.environ,
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "mpassit_tpu_torch", nml],
                            cwd=WORK, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"main_path_written: over {timeout} s, killed")
    t_child = time.perf_counter() - t0
    stages = {m.group(1): float(m.group(2))
              for m in re.finditer(STAGE_LINE, stderr, re.M)}
    line = {"phase": "main_path_written", "rc": proc.returncode,
            "t_s": t_child, "nvidia_smi": smi, "stages_s": stages,
            "write_to_file_s": stages.get("write_to_file"),
            "data_bytes": nbytes, "free_bytes_before": free,
            "reference_digest_s": t_ref, "reduced": reduced + cut}
    ok_ = proc.returncode == 0 and os.path.exists(out)
    if ok_:
        line["file_bytes"] = os.path.getsize(out)
        with open(out, "rb") as f:
            line["hdf5_signature"] = ok_ = f.read(8) == b"\x89HDF\r\n\x1a\n"
    if ok_:
        t0 = time.perf_counter()
        with open_dataset(out) as f:
            line["reader"] = type(f._f).__module__
        got = digest_file(out)
        line["read_back_s"] = time.perf_counter() - t0
        differ, missing = compare_digests(ref, got)
        line["vars_match"] = sum(1 for v in ref if got.get(v) == ref[v])
        line["n_vars_differ"] = len(differ)
        line["vars_differ"] = differ
        line["levels"] = sum(len(v) for v in got.values())
        ok_ = not differ and not missing
        os.remove(out)
    line["ok"] = bool(ok_)
    line["t_phase_s"] = time.perf_counter() - t_phase
    if not ok_:
        line["stdout_tail"] = stdout[-1500:]
        line["stderr_tail"] = stderr[-1500:]
    emit(line)
    if not ok_:
        raise SystemExit("main_path_written failed its checks")


def _matrix_namelist(nml, name):
    """The main path's namelist (inputs, varlists, weights cache) with its
    target grid replaced by MATRIX[name]'s; returns its path."""
    lines, extra = [], [e.format(fixtures=FIXTURES) for e in MATRIX[name][0]]
    with open(nml) as f:
        for line in f:
            key = line.split("=")[0].strip().lower()
            if key in GRID_KEYS:
                continue
            if line.strip() == "/":
                lines += [f" {e}\n" for e in extra + [
                    f'output_file = "{WORK}/matrix_{name}.nc"']]
            lines.append(line)
    path = os.path.join(WORK, f"namelist_matrix_{name}.input")
    with open(path, "w") as f:
        f.write("".join(lines))
    return path


def fixtures_check():
    """The committed netCDF-C fixtures read through the port's HDF5 reader
    (h5py is not used even where importable): every dataset and attribute
    against the manifest made from h5py's read. Returns {file: ok}."""
    from mpassit_tpu_torch.io import hdf5
    from mpassit_tpu_torch.testing import describe_hdf5

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    out = {}
    for name, want in manifest.items():
        r = hdf5.open_file(os.path.join(FIXTURES, name))
        try:
            got = json.loads(json.dumps(describe_hdf5(r)))
        finally:
            r.close()
        out[name] = got == want
    return out


def _median_s(fn, min_s):
    """The median seconds of ``fn()`` over at least 3 calls and
    ``min_s`` s; and its last result."""
    times, end = [], time.perf_counter() + min_s
    while len(times) < 3 or time.perf_counter() < end:
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def decode_rates(name="wrf_lambert_latest.nc", min_s=0.2):
    """The port's HDF5 reader on a committed fixture, in MB/s of decoded
    bytes per chunk index and per filter: each chunked dataset read whole
    (its index walked, every chunk read and decoded; a chunk a filter did
    not shrink is stored raw and counted with it), summed over the
    datasets that use it. Medians of at least 3 reads and ``min_s`` s per
    dataset."""
    from mpassit_tpu_torch.io import hdf5

    totals = {}
    r = hdf5.open_file(os.path.join(FIXTURES, name))
    try:
        for _, ds in r.items():
            st = ds.storage()
            if st["layout"] != "chunked" or not st["allocated"]:
                continue
            t, a = _median_s(lambda: ds[...], min_s)
            for key in [f"index_{st['index']}"] + [
                    f"filter_{f}" for f in st["filters"]]:
                b, s = totals.get(key, (0, 0.0))
                totals[key] = (b + a.nbytes, s + t)
    finally:
        r.close()
    return {k: {"mb_s": b / s / 1e6, "bytes": b, "s": s}
            for k, (b, s) in sorted(totals.items())}


def matrix_phase(pipeline, nml, device, seed, reduced, arts, calls, packs,
                 split):
    """main_path_matrix: the CLI function on the main path's inputs and
    varlists (919 packed columns, full width) once per MATRIX target, each
    grid cut to keep the phase within MATRIX_BUDGET_S (its cut in
    ``reduced``), weights cold. Each run must launch packed_apply the 3
    times it owes (the pack, EDGE1, EDGE2) with no plain call, rotate in
    the kernel only on a Lambert target (the file's), and hold every
    variable within TOL_REL of the float64 evaluation (no Q4 rotation off
    Lambert). Then the committed fixtures against their manifest. Returns
    (the mercator run's artifact, its result dropped, and launches)."""
    import gc

    import torch

    from mpassit_tpu_torch.constants import PROJ_LC

    t_phase = time.perf_counter()
    mercator = None
    for name, (_, cut) in MATRIX.items():
        path = _matrix_namelist(nml, name)
        arts.clear()
        calls.clear()
        packs.clear()
        split.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        _zero_counters()
        t0 = time.perf_counter()
        rc = pipeline.main([path])
        t_main = time.perf_counter() - t0
        launches, plain_calls = _counters()
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        art = arts[0] if arts else None
        line = {"phase": "main_path_matrix", "target": name, "rc": rc,
                "t_s": t_main, "reduced": reduced + [cut]}
        if rc != 0 or art is None:
            emit({**line, "ok": False})
            raise SystemExit(f"main_path_matrix {name} failed: rc={rc}")
        art.regridders.clear()
        expected = expected_launches("ell", calls)
        lc = art.cfg.proj_code == PROJ_LC
        rotated = [bool(p["rotate"]) for p in packs]
        t0 = time.perf_counter()
        errs = check_outputs(art, 4000, seed)
        line.update(
            grid=[art.grid.ny, art.grid.nx], proj_code=art.cfg.proj_code,
            map_proj_char=art.cfg.map_proj_char,
            stages_s=art.timings.stages,
            interp_data_split_s=interp_split(art, split),
            launches=launches, expected_launches=expected,
            applies=list(calls), packs=list(packs), plain_calls=plain_calls,
            peak_device_gb=peak, in_kernel_rotation=rotated,
            check_s=time.perf_counter() - t0, tol_rel=TOL_REL,
            max_rel_err=max(errs.values()), n_vars=len(errs),
            per_var_max_rel_err=errs)
        line["ok"] = ok_ = bool(
            launches == expected and expected["packed_apply"] == 3
            and not any(plain_calls.values())
            and rotated == [lc] and max(errs.values()) <= TOL_REL)
        emit(line)
        if not ok_:
            raise SystemExit(f"main_path_matrix {name} failed its checks")
        if name == "mercator":
            art.result = art.data = None
            mercator = (art, launches["packed_apply"], packs[0]["cols"])
        del art
    fixtures = fixtures_check()
    rates = decode_rates()
    t_phase = time.perf_counter() - t_phase
    line = {"phase": "main_path_matrix", "fixtures_match_manifest":
            fixtures, "decode_mb_s": rates, "nvidia_smi": nvidia_smi(),
            "t_phase_s": t_phase, "budget_s": MATRIX_BUDGET_S}
    line["ok"] = ok_ = all(fixtures.values()) and t_phase <= MATRIX_BUDGET_S
    emit(line)
    if not ok_:
        raise SystemExit("main_path_matrix failed its checks")
    return mercator


def production_phase(ncells, timeout=600):
    """production_e2e: tools/bench_production.py with ``--writer digest``
    at ``ncells`` in processes of its own (the mesh cache and the built
    kernel libraries of the earlier phases found). Fails unless both
    children exit 0 and their digest maps are equal and complete. The tool
    runs in a session of its own, which is killed whole at ``timeout``
    seconds."""
    import signal

    out = os.path.join(WORK, "production_e2e_torch.json")
    cmd = [sys.executable, "-m", "mpassit_tpu_torch.tools.bench_production",
           "--writer", "digest", "--ncells", str(ncells),
           "--cache-dir", WORK, "--out", out, "--timeout", str(timeout)]
    env = dict(os.environ, MPASSIT_PLATFORM="cuda",
               PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"production_e2e: over {timeout} s, killed")
    t_s = time.perf_counter() - t0
    res = {}
    if os.path.exists(out):
        with open(out) as f:
            res = json.load(f)
    line = {"phase": "production_e2e", "rc": proc.returncode, "t_s": t_s,
            "cmd": " ".join(cmd[1:]), **res,
            "reduced": res.get("reduced", [])}
    line["ok"] = ok_ = bool(
        proc.returncode == 0 and res.get("ok")
        and res.get("streamed_equals_inmemory_digest")
        and not res.get("writer_mismatch") and not res.get("digest_missing")
        and not res.get("rss_run_errors")
        and res.get("writer") == "digest")
    if not ok_:
        line["stdout_tail"] = stdout[-1500:]
        line["stderr_tail"] = stderr[-1500:]
    emit(line)
    if not ok_:
        raise SystemExit("production_e2e failed its checks")


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
    from mpassit_tpu_torch.io import netcdf_c
    # the plain one-hot versions' "highest" product needs full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "h5py": has_h5py, "ninja": importable("ninja"),
          "libnetcdf": netcdf_c.available(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    device = torch.device("cuda", 0)

    # --- build: one nvcc per source, all started together ----------------
    from concurrent.futures import ThreadPoolExecutor

    from mpassit_tpu_torch.ops import gather_kernel as gk
    from mpassit_tpu_torch.ops import onehot_kernel as ok
    from mpassit_tpu_torch.ops import packed_kernel as pk
    from mpassit_tpu_torch.ops import variant_kernels as vk
    from mpassit_tpu_torch.ops import write_wall as ww

    from mpassit_tpu_torch.io import h5filters

    mods = (pk, ok, gk, ww, vk)

    def timed_build(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods) + 1) as ex:
        futures = [ex.submit(m.build) for m in mods]
        h5_build = ex.submit(timed_build, h5filters.build)
        for f in futures:
            f.result()
        h5_build_s = h5_build.result()
    build_s = time.perf_counter() - t0
    for m in mods:
        for line in m.BUILD_INFO["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {os.path.basename(m.SOURCE)}:", line.strip())
    # the tensor-core sources: registers, spills and their SASS
    tc = {os.path.basename(m.SOURCE): {
        "kernels": ptxas_summary(m.BUILD_INFO["log"]),
        "sass_instructions": sass_counts(m.BUILD_INFO["so"], m.SOURCE)}
        for m in (ok, vk)}
    emit({"phase": "build", "build_s": build_s,
          "sources": [{"source": os.path.relpath(m.SOURCE, HERE),
                       "so": os.path.relpath(m.BUILD_INFO["so"], HERE),
                       "nvcc_s": m.BUILD_INFO["seconds"]} for m in mods]
          + [{"source": os.path.relpath(h5filters.SOURCE, HERE),
              "so": os.path.relpath(h5filters.library_path(), HERE),
              "gxx_s": h5_build_s}],
          **tc})
    for src, info in tc.items():
        sass = info["sass_instructions"]
        if sass is not None and not sass["HGMMA"]:
            raise SystemExit(f"{src} has no HGMMA (wgmma) instruction")

    # --- inputs ----------------------------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    (nml, nml_streamed, *nml_sharded), info = prepare_inputs(
        WORK, os.path.join(HERE, "parm"), args.ncells, args.seed,
        classic=not has_h5py)
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

    arts, calls, packs, pack_geom = [], [], [], {}
    run_pipeline = pipeline.run_pipeline

    def observed_run(cfg, device, dtype=None):
        art = run_pipeline(cfg, device, dtype)
        arts.append(art)
        return art

    apply_np = matmul_apply.PackedSlabRegridder.apply_np

    def recorded(self, src, cols=None, rotate=(), **kw):
        """Each apply as [kind, Cp, group width (0: one pass)]: "packed"
        for the union of the methods, which brings its column counts,
        "slab" for one operator's."""
        blocks = src if isinstance(src, (list, tuple)) else [src]
        C = sum(1 if np.ndim(b) == 1 else np.shape(b)[1] for b in blocks)
        calls.append(["slab" if cols is None else "packed",
                      matmul_apply.padded(C), 0])
        if cols is not None:
            packs.append({"cols": list(cols), "W": self.W,
                          "rotate": [list(w) for w in rotate]})
        return apply_np(self, src, cols, rotate, **kw)

    width = matmul_apply.PackedSlabRegridder._grouped_width

    def width_wrapped(self, Cp, rotate=()):
        """The group width the regridder chose for the apply being
        recorded, and its pack's geometry."""
        gw = width(self, Cp, rotate)
        if gw:
            calls[-1][2] = gw
        if gw and calls[-1][0] == "packed":
            pack_geom.update(cols=packs[-1]["cols"], rotate=tuple(rotate),
                             gw=gw)
        return gw

    pipeline.run_pipeline = observed_run
    matmul_apply.PackedSlabRegridder.apply_np = recorded
    matmul_apply.PackedSlabRegridder._grouped_width = width_wrapped
    # the band gather of the sharded phase, bracketed by synchronizes
    split = {}
    if not has_h5py:
        # the in-process runs keep their result in memory and write no
        # file: this keeps the smoke run's time (each 7-GB write is taken
        # once, by main_path_written's CLI process). The output is no
        # longer unwritable without h5py (io/hdf5.py)
        pipeline.write_output = lambda path, cfg, grid, data, res: None
        print(json.dumps({"output_write": "captured in memory in the "
                          "in-process runs; main_path_written writes it"}))
    os.environ["MPASSIT_PLATFORM"] = "cuda"
    route_launches, default_art, peaks = {}, None, {}
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
        expected = expected_launches(route, calls)
        peaks[route] = torch.cuda.max_memory_allocated(device) / 1e9
        emit({"phase": phase, "switches": switches, "rc": rc, "t_s": t_main,
              "stages_s": art.timings.stages if art else {},
              "interp_data_split_s": interp_split(art, split),
              "launches": launches,
              "expected_launches": expected, "applies": list(calls),
              "plain_calls": plain_calls, "peak_device_gb": peaks[route],
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
            from mpassit_tpu_torch.io.nc4 import open_dataset

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

    # --- the CLI in a process of its own, its NetCDF4 file read back -------
    written_phase(pipeline, nml, default_art, arts, smi, reduced)

    # --- the namelist-path matrix: other targets, the file target --------
    mercator = matrix_phase(pipeline, nml, device, args.seed, reduced, arts,
                            calls, packs, split)

    # --- the main path sharded: a world of one over NCCL --------------------
    route_launches["sharded"] = sharded_phase(
        pipeline, nml, nml_sharded, default_art, device, args.seed, reduced,
        arts, calls, split)
    ranks_phase(nml, nml_sharded, default_art, torch.cuda.device_count())

    # --- the default route again, profiled ---------------------------------
    route_launches["profiled"] = profiled_phase(
        pipeline, nml, default_art, arts, calls, reduced)

    # --- the production configuration: streamed, grouped ------------------
    arts.clear()
    calls.clear()
    split.clear()
    pack_geom.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    route_launches["streamed"] = streamed_phase(
        pipeline, nml_streamed, default_art, device, args.seed, reduced,
        peaks["ell"], arts, calls, split, pack_geom)
    arts.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # --- kernel vs plain, the write wall, the kernel variants --------------
    cases, summary = kernel_vs_plain(
        default_art, device, args.seed,
        {k: route_launches[PHASE_OF[k]][k] for k in KERNELS
         if PHASE_OF[k] in route_launches}, pack_geom,
        route_launches["streamed"], mercator)
    del mercator
    grid = default_art.grid
    phase_launches = dict(route_launches)
    phase_launches["write_wall"], summary["write_wall"] = write_wall_phase(
        device, -(-grid.ny // 32), -(-grid.nx // 32),
        summary["packed_apply"]["ms"], summary["onehot_apply_packed"]["ms"],
        args.seed)
    phase_launches["kernel_variants"] = kernel_variants_phase(
        default_art, device, args.seed, reduced)
    del default_art, arts[:], grid
    gc.collect()
    torch.cuda.empty_cache()

    # --- the production tool, its runs in processes of their own ----------
    production_phase(args.ncells)
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
