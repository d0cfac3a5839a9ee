"""Production-shape end-to-end run of the port, each writer in its own process.

    python -m mpassit_tpu_torch.tools.bench_production --writer netcdf4|digest
        [--ncells 2600000] [--nz 55] [--nx 1801] [--ny 1061]
        [--cache-dir DIR] [--out FILE] [--rss-only] [--timeout S]

Counterpart of ``tools/bench_production.py``, with its structure, names and
recipe:

- inputs (``build_inputs``): a synthetic global Voronoi mesh of
  ``--ncells`` cells (2.6M by default, cached on disk by
  ``tools/kernel_variants._cached_mesh``), nz 55, nsoil 4; the same smooth
  fields for the shipped ``parm/`` varlists plus ``vorticity VORT`` (973
  columns at nz 55); written as CDF-2 with ``Time`` the record dimension
  (``mpassit_tpu_torch/testing.py``), so no h5py is needed; the target is
  the 1801x1061 3-km Lambert CONUS grid (a smaller ``--nx``/``--ny``
  keeps the CONUS extent: dx = 3 km x 1801 / nx);
- the weights and packs are built once in this process on the host
  (``warm_cache``, timed apart, no device), and on a CUDA platform the five
  kernel libraries too, so that both measured children are process-cold
  and cache-warm;
- two measured children (``_rss_runs``), one after the other: the streamed
  run (``stream_output = .true.``) and the in-memory run, each through the
  CLI's ``run_pipeline`` (``pipeline.main``) in a subprocess of its own, on
  the platform ``MPASSIT_PLATFORM`` names as the CLI reads it (``cuda``
  by default). Each records its wall clock, ``Timings`` stages,
  ``ru_maxrss``, ``torch.cuda.max_memory_allocated`` and what it paid
  before its first apply: ``import torch``, the CUDA context (first
  allocation) and loading the five kernel libraries (cold builds or found
  in ``_build/``);
- ``--writer`` (no default, no fallback): ``netcdf4`` writes real files
  (through the port's own HDF5 encoder, ``io/hdf5.py``: no h5py needed)
  and compares them variable by variable, bit for bit (``compare_files``,
  through ``open_dataset``: the port's HDF5 reader where h5py is not
  installed); ``digest`` installs ``DigestFile`` in place of the NetCDF4
  file in each child, which takes a blake2b digest of exactly the arrays
  the NetCDF4 writer would store, per variable and level, and the two
  digest maps are compared. A digest is a choice, for a disk that cannot
  hold both runs' files (two 7-GB files at the CONUS grid): a digest run
  writes no file, so its writer spans (``write_to_file``, ``write.finish``,
  ``write.block``, ``write.store``) and overlap are reported as null with
  the reason, its digest times apart;
- ``fetch_probe``: in a child, one 256-MiB device -> host copy, pageable
  (``Tensor.cpu()``) and into a pinned buffer.

The artifact goes to ``--out`` (``.bench_cache/production_e2e_torch.json``
by default), never to the JAX package's ``PRODUCTION_E2E.json``. Each
comparison starts from an empty mismatch list, ``--rss-only`` included
(which reruns the children into an existing artifact). Exit code 0 when
both children ran and their outputs are equal and complete, 1 otherwise
(and at once when ``MPASSIT_PLATFORM`` is ``cuda`` and there is no CUDA
device).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NCELLS = 2_600_000
NZ = 55
NSOIL = 4
NX = 1801
NY = 1061
DX = 3000.0         # at NX; a smaller grid keeps the extent
#: the writer's times a digest run cannot give
NO_WRITER = "--writer digest chosen: digest stand-in, no file written"


def _production_dir(cache_dir):
    return os.path.join(cache_dir, "production_torch")


def build_inputs(cache_dir, ncells=NCELLS, nz=NZ, force=False):
    """Write the production-scale grid/hist/diag files + varlist dir (once
    per size; ~10.5 GB at 2.6M cells, reused by every run). Returns the
    directory."""
    from ..testing import write_data_file_classic, write_grid_file_classic
    from .kernel_variants import _cached_mesh

    d = _production_dir(cache_dir)
    stamp = os.path.join(d, ".complete")
    tag = f"{ncells}_{nz}_{NSOIL}"
    if not force and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == tag:
                return d
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    mesh = _cached_mesh(cache_dir, ncells, nz, NSOIL)
    print(f"- mesh ready ({time.perf_counter() - t0:.0f}s)", flush=True)
    write_grid_file_classic(mesh, os.path.join(d, "grid.nc"))

    lat, lon = mesh.lat_cell, mesh.lon_cell
    f2 = (np.sin(np.deg2rad(lat)) * np.cos(np.deg2rad(lon))).astype(
        np.float32)
    f2v = (np.sin(np.deg2rad(mesh.lat_vertex))
           * np.cos(np.deg2rad(mesh.lon_vertex))).astype(np.float32)
    zlev = np.linspace(0.0, 1.0, nz, dtype=np.float32)
    zlevp1 = np.linspace(0.0, 1.0, nz + 1, dtype=np.float32)
    zsoil = np.linspace(0.0, 1.0, NSOIL, dtype=np.float32)

    def f3(levs, base=0.0, scale=1.0):
        return lambda: base + scale * (f2[:, None] + levs[None, :])

    diag2d = ["rainc", "rainnc", "snowncv", "rainncv", "graupelncv",
              "prec_acc_c", "prec_acc_nc", "snow_acc_nc", "refl10cm_max",
              "refl10cm_1km", "refl10cm_1km_max", "u10", "v10", "q2",
              "t2m", "th2m", "updraft_helicity_max", "w_velocity_max"]
    diag_fields = {name: 1.0 + (i + 1) * 0.1 * f2
                   for i, name in enumerate(diag2d)}
    diag_fields["refl10cm"] = f3(zlev, 20.0, 10.0)
    attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 60.0,
             "config_lsm_scheme": "noah",
             "config_microp_scheme": "mp_thompson",
             "config_convection_scheme": "cu_ntiedke"}
    t0 = time.perf_counter()
    write_data_file_classic(mesh, os.path.join(d, "diag.nc"), diag_fields,
                            attrs=attrs, dtype="f4")
    print(f"- diag.nc written ({time.perf_counter() - t0:.0f}s)",
          flush=True)

    hist_fields = {
        "surface_pressure": 1.0e5 + 1000.0 * f2,
        "xland": np.where(lat > 0, 1.0, 2.0).astype(np.float32),
        "skintemp": 285.0 + 5.0 * f2,
        "snow": np.maximum(0.0, 100.0 * f2),
        "snowh": np.maximum(0.0, 1.0 * f2),
        "sst": 290.0 + 3.0 * f2,
        "zgrid": f3(zlevp1, 100.0, 1000.0),
        "w": f3(zlevp1, 0.0, 0.1),
        "theta": f3(zlev, 300.0, 10.0),
        "uReconstructZonal": f3(zlev, 15.0, 1.0),
        "uReconstructMeridional": f3(zlev, -5.0, 1.0),
        "qv": f3(zlev, 1e-3, 1e-3), "qc": f3(zlev, 0.0, 1e-4),
        "qr": f3(zlev, 0.0, 1e-4), "qi": f3(zlev, 0.0, 1e-4),
        "qs": f3(zlev, 0.0, 1e-4), "qg": f3(zlev, 0.0, 1e-4),
        "ni": f3(zlev, 0.0, 1e3), "nr": f3(zlev, 0.0, 1e3),
        "pressure": f3(zlev, 2e4, -1e4),
        "rho": f3(zlev, 1.0, 0.1),
        "vorticity": lambda: 1e-4 * (f2v[:, None] + zlev[None, :]),
        "tslb": f3(zsoil, 275.0, 1.0),
        "smois": f3(zsoil, 0.3, 0.1),
        "sh2o": f3(zsoil, 0.2, 0.1),
    }
    t0 = time.perf_counter()
    write_data_file_classic(mesh, os.path.join(d, "hist.nc"), hist_fields,
                            attrs=attrs, dtype="f4")
    print(f"- hist.nc written ({time.perf_counter() - t0:.0f}s)",
          flush=True)

    # varlists: the shipped parm/ content verbatim + a vorticity line (the
    # vertex-located path) for the full 973-column load
    vd = os.path.join(d, "parm")
    os.makedirs(vd, exist_ok=True)
    src_parm = os.path.join(REPO, "parm")
    for name in ("diaglist", "histlist_2d", "histlist_soil"):
        with open(os.path.join(src_parm, name)) as f:
            content = f.read()
        with open(os.path.join(vd, name), "w") as f:
            f.write(content)
    with open(os.path.join(src_parm, "histlist_3d")) as f:
        h3 = f.read()
    with open(os.path.join(vd, "histlist_3d"), "w") as f:
        f.write(h3.rstrip("\n") + "\nvorticity VORT\n")
    with open(stamp, "w") as f:
        f.write(tag)
    return d


def _namelist_text(d, cache_dir, out_file, stream, nx=NX, ny=NY):
    dx = DX * NX / nx
    return f"""&config
 grid_file_input_grid = "{os.path.join(d, 'grid.nc')}"
 diag_file_input_grid = "{os.path.join(d, 'diag.nc')}"
 hist_file_input_grid = "{os.path.join(d, 'hist.nc')}"
 output_file = "{out_file}"
 interp_diag = .true.
 interp_hist = .true.
 wrf_mod_vars = .true.
 target_grid_type = 'lambert'
 nx = {nx + 1}
 ny = {ny + 1}
 dx = {dx}
 dy = {dx}
 ref_lat = 38.5
 ref_lon = -97.5
 truelat1 = 38.5
 stand_lon = -97.5
 varlist_dir = "{os.path.join(d, 'parm')}"
 weights_cache_dir = "{cache_dir}"
 stream_output = {'.true.' if stream else '.false.'}
/
"""


def warm_cache(nml):
    """Every weight set and pack the run of ``nml`` needs, built (or found)
    in the weights cache on the host, as the pipeline's weight stage
    builds them; no device is touched."""
    import torch

    from ..config import Config
    from ..fields.registry import build_routing
    from ..grids.target import build_target_grid
    from ..mesh.mpas import mesh_from_file
    from ..mesh.reorder import reorder_cells_by_latitude, reorder_cells_morton
    from ..ops.matmul_apply import PackedSlabRegridder
    from ..run.pipeline import _make_regridder, build_weights

    cfg = Config.from_namelist(nml)
    grid = build_target_grid(cfg)
    mesh = mesh_from_file(cfg.grid_file_input_grid)
    if cfg.cell_order == "morton":
        mesh = (reorder_cells_morton(mesh, grid.proj)
                if grid.proj is not None
                else reorder_cells_by_latitude(mesh)).mesh
    routing = build_routing(cfg.varlist_dir, cfg.interp_diag,
                            cfg.interp_hist, cfg.wrf_mod_vars)
    weights = build_weights(cfg, mesh, grid, routing)
    cpu, cache = torch.device("cpu"), cfg.weights_cache_dir
    for ell in weights.values():
        _make_regridder(ell, torch.float32, cpu, cache_dir=cache)
    cell = [k for k in ("bilinear", "nearest", "conserve") if k in weights]
    if len(cell) >= 2:
        PackedSlabRegridder([weights[k] for k in cell], cpu,
                            cache_dir=cache)
    return sorted(weights)


def build_kernels():
    """Build (or find in ``_build/``) the five kernel libraries, one nvcc
    each, started together. Returns [{source, nvcc_s}]: nvcc_s None when
    the library was found built."""
    from concurrent.futures import ThreadPoolExecutor

    from ..ops import gather_kernel, onehot_kernel, packed_kernel
    from ..ops import variant_kernels, write_wall

    mods = (packed_kernel, onehot_kernel, gather_kernel, write_wall,
            variant_kernels)
    with ThreadPoolExecutor(len(mods)) as ex:
        for f in [ex.submit(m.build) for m in mods]:
            f.result()
    return [{"source": os.path.basename(m.SOURCE),
             "nvcc_s": m.BUILD_INFO["seconds"]} for m in mods]


# ------------------------------------------------------------- digests ----

def _digest(plane) -> str:
    return hashlib.blake2b(np.ascontiguousarray(plane),
                           digest_size=16).hexdigest()


class _ReadBack:
    """``DigestFile._f``: the in-memory writer reads Z_C back after
    defining it with its fill; a variable written with one value
    throughout can be read back, no other."""

    def __init__(self, owner):
        self.owner = owner

    def __getitem__(self, name):
        shape, dtype = self.owner.vars[name]
        if name not in self.owner.const:
            raise ValueError(f"DigestFile keeps no data of {name}")
        return np.full(shape, self.owner.const[name], dtype)


class DigestFile:
    """Stands in for ``io/nc4.NetCDF4File`` in write mode where no NetCDF4
    file is to be written (``--writer digest``). The writers' calls run
    as they would; each write
    digests what the file would store (the data in the variable's dtype,
    C order): per level (axis 1) of a 4-D variable, else the whole
    variable as level 0. A level written again is digested again, so the
    last write wins, as in the file. Attributes are not kept. ``sink``
    receives {var: {level: digest}}, per var its shape and bytes, and
    the time the stand-in itself took (``t_digest_s``)."""

    def __init__(self, sink, path, mode="w"):
        if mode not in ("w", "w-", "x"):
            raise ValueError("DigestFile only writes")
        self.path, self.sink = path, sink
        self.dims, self.vars, self.const = {}, {}, {}
        self._f = _ReadBack(self)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def close(self):
        pass

    def create_dim(self, name, size):
        self.dims[name] = 0 if size is None else size

    def ensure_unlimited_size(self, name, size):
        self.dims[name] = max(self.dims[name], size)

    def set_attr(self, name, value, var=None):
        pass

    def has_var(self, name):
        return name in self.vars

    def create_var(self, name, dims, dtype, data=None):
        shape = tuple(self.dims[d] for d in dims)
        self.vars[name] = (shape, np.dtype(dtype))
        self.sink.setdefault("shapes", {})[name] = list(shape)
        self.sink.setdefault("bytes", {})[name] = (
            int(np.prod(shape)) * self.vars[name][1].itemsize)
        self.sink.setdefault("digests", {})[name] = {}
        if data is not None:
            self.write_var(name, data)

    def write_var(self, name, data):
        self.write_var_slab(name, data, (0,) * len(self.vars[name][0]))

    def write_var_slab(self, name, data, starts):
        t0 = time.perf_counter()
        shape, dtype = self.vars[name]
        a = np.asarray(data).astype(dtype, copy=False)
        whole = tuple(starts) == (0,) * len(shape) and a.shape == shape
        if len(shape) == 4:
            lev0 = starts[1]
            if (a.ndim != 4 or a.shape[0] != 1 or tuple(starts[2:]) != (0, 0)
                    or a.shape[2:] != shape[2:]):
                raise ValueError(f"{name}: a write of part of a level "
                                 f"({a.shape} at {starts})")
            planes = [(lev0 + k, a[0, k]) for k in range(a.shape[1])]
        elif whole:
            planes = [(0, a)]
        else:
            raise ValueError(f"{name}: a partial write ({a.shape} at "
                             f"{starts}) of a variable without levels")
        digests = self.sink["digests"][name]
        for lev, plane in planes:
            digests[lev] = _digest(plane)
        self.const.pop(name, None)
        if whole and a.size and a.flat[0] == a.flat[-1] and (
                a == a.flat[0]).all():
            self.const[name] = a.flat[0]
        self.sink["t_digest_s"] = (self.sink.get("t_digest_s", 0.0)
                                   + time.perf_counter() - t0)


def digest_map(sink) -> dict:
    """{var: [digest of level 0, 1, ...]} from a DigestFile sink, None for
    a level never written."""
    out = {}
    for var, levels in sink.get("digests", {}).items():
        shape = sink["shapes"][var]
        n = shape[1] if len(shape) == 4 else 1
        out[var] = [levels.get(k) for k in range(n)]
    return out


def digest_file(path) -> dict:
    """The digest map of an existing output file, read back: what a
    DigestFile would hold had it stood in for the writer of that file."""
    from ..io.nc4 import open_dataset

    out = {}
    with open_dataset(path) as f:
        for var in f.var_names():
            a = np.asarray(f.read_var(var))
            out[var] = ([_digest(a[0, k]) for k in range(a.shape[1])]
                        if a.ndim == 4 else [_digest(a)])
            del a
    return out


def compare_digests(a, b):
    """(names of the variables whose digests differ, in ``a``'s order and
    then ``b``'s extras; {var: levels missing} of either map)."""
    mismatch = [v for v in a if a[v] != b.get(v)]
    mismatch += [v for v in b if v not in a]
    missing = {v: [k for k, d in enumerate(m[v]) if d is None]
               for m in (a, b) for v in m if None in m[v]}
    return mismatch, missing


def compare_files(path_a, path_b):
    """Names of the variables of two NetCDF files that differ (float
    arrays bit for bit with NaN equal to NaN), or are in only one."""
    from ..io.nc4 import open_dataset

    mismatch = []
    with open_dataset(path_a) as a, open_dataset(path_b) as b:
        names_b = b.var_names()
        for name in a.var_names():
            if name not in names_b:
                mismatch.append(name)
                continue
            x, y = np.asarray(a.read_var(name)), np.asarray(b.read_var(name))
            if not (x.shape == y.shape and (
                    np.array_equal(x, y, equal_nan=True)
                    if x.dtype.kind == "f" else np.array_equal(x, y))):
                mismatch.append(name)
            del x, y        # a classic file's arrays are views of its map
        mismatch += [n for n in names_b if n not in a.var_names()]
    return mismatch


# -------------------------------------------------------------- children ----

_CHILD = """\
import sys, time
t0 = time.perf_counter()
import torch
t_torch = time.perf_counter() - t0
from mpassit_tpu_torch.tools.bench_production import _child
sys.exit(_child(sys.argv[1], sys.argv[2], sys.argv[3], t0, t_torch))
"""


def _child(nml, side, writer, t0, t_import_torch) -> int:
    """One measured run of the CLI on ``nml`` in this process; its record
    goes to the JSON file ``side``."""
    import resource

    import torch

    from ..io import wrf_writer
    from ..run import pipeline

    device = pipeline.resolve_device(
        os.environ.get("MPASSIT_PLATFORM", "cuda"))
    pre = {"import_torch_s": t_import_torch}
    if device.type == "cuda":
        t = time.perf_counter()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        pre["cuda_context_s"] = time.perf_counter() - t
        t = time.perf_counter()
        pre["kernel_libraries"] = build_kernels()
        pre["kernel_libraries_s"] = time.perf_counter() - t
        pre["kernel_libraries_were"] = (
            "found in _build/" if all(k["nvcc_s"] is None
                                      for k in pre["kernel_libraries"])
            else "built cold")
    else:
        pre.update(cuda_context_s=None, kernel_libraries_s=None,
                   reason="MPASSIT_PLATFORM=cpu: no CUDA context, the "
                          "kernels' plain versions run")
    sink = {}
    if writer == "digest":
        wrf_writer.NetCDF4File = lambda path, mode="w": DigestFile(
            sink, path, mode)
    arts = []
    run = pipeline.run_pipeline

    def observed(cfg, device, dtype=None):
        arts.append(run(cfg, device, dtype))
        return arts[-1]
    pipeline.run_pipeline = observed
    t = time.perf_counter()
    rc = pipeline.main([nml])
    rec = {
        "rc": rc, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else None),
        "wall_s": time.perf_counter() - t0,
        "pipeline_s": time.perf_counter() - t,
        "pre_first_apply": pre,
        "stages": arts[0].timings.stages if arts else None,
        "maxrss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024,
        "peak_device_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None),
    }
    if writer == "digest":
        rec["digests"] = digest_map(sink)
        rec["digested_bytes"] = sum(sink.get("bytes", {}).values())
        rec["digest_s"] = sink.get("t_digest_s", 0.0)
    with open(side, "w") as f:
        json.dump(rec, f)
    return rc


def _writer_times(stages, writer, digest_s=None):
    """The writer's stage times: in a digest run null, with the reason,
    and apart the stage times the writer's code took around the stand-in
    and, of them, the stand-in's own (``digest_s``)."""
    stages = dict(stages or {})
    keys = ("write_to_file", "write.finish", "write.block", "write.store")
    if writer == "digest":
        stand_in = {k: stages[k] for k in keys if k in stages}
        for k in stand_in:
            stages[k] = None
        stand_in["digest_s"] = digest_s
        return stages, {"writer_times": None, "reason": NO_WRITER,
                        "digest_stand_in_s": stand_in}
    out = {}
    # the writer thread's blocks against what the run waited for at the end
    if stages.get("write.block"):
        out["stream_overlap"] = 1.0 - (stages["write.finish"]
                                       / stages["write.block"])
    return stages, out


def _rss_runs(d, cache_dir, res, writer, shape, timeout=7200):
    """Each writer's pipeline in its OWN subprocess, one after the other
    (ru_maxrss = the clean per-writer peak host memory). Returns the
    output path (netcdf4) or digest map (digest) of each run."""
    peak, dev_peak, wall, stages, pre, extra, outs = ({}, {}, {}, {}, {},
                                                      {}, {})
    for tag, stream in (("streamed", True), ("in_memory", False)):
        out_nc = os.path.join(d, f"rss_{tag}.nc")
        nml = os.path.join(d, f"namelist.rss_{tag}")
        side = os.path.join(d, f"rss_{tag}.json")
        for p in (side, out_nc):
            if os.path.exists(p):
                os.unlink(p)
        with open(nml, "w") as f:
            f.write(_namelist_text(d, cache_dir, out_nc, stream, *shape))
        env = dict(os.environ,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, "-c", _CHILD, nml, side,
                                writer], env=env, capture_output=True,
                               text=True, timeout=timeout)
            if os.path.exists(side):
                with open(side) as f:
                    got = json.load(f)
                peak[tag] = got["maxrss_mb"]
                dev_peak[tag] = got["peak_device_gb"]
                wall[tag] = got["wall_s"]
                stages[tag], extra[tag] = _writer_times(
                    got["stages"], writer, got.get("digest_s"))
                pre[tag] = got["pre_first_apply"]
                if r.returncode == 0:
                    outs[tag] = (got["digests"] if writer == "digest"
                                 else out_nc)
                if tag == "streamed" and writer == "digest":
                    res["output_gb"] = got["digested_bytes"] / 1e9
                    res["output_gb_is"] = ("the bytes of every variable "
                                           "digested: what the file's data "
                                           "would hold")
            if r.returncode != 0:
                res.setdefault("rss_run_errors", {})[tag] = (
                    f"rc={r.returncode} " + r.stdout[-300:]
                    + r.stderr[-600:])
        except subprocess.TimeoutExpired:
            res.setdefault("rss_run_errors", {})[tag] = "timeout"
        process_s = time.perf_counter() - t0
        res.setdefault("subprocess_process_s", {})[tag] = process_s
        print(f"- subprocess {tag}: rss {peak.get(tag)} MB, "
              f"{process_s:.0f}s", flush=True)
    res["peak_host_rss_mb_subprocess"] = peak
    res["peak_device_gb_subprocess"] = dev_peak
    res["subprocess_wall_s"] = wall
    res["subprocess_stages"] = stages
    res["subprocess_writer"] = extra
    res["pre_first_apply"] = pre
    if "streamed" in peak and "in_memory" in peak:
        res["streamed_below_in_memory"] = peak["streamed"] < peak["in_memory"]
    return outs


def _compare(outs, res, writer, keep_outputs):
    """The two runs' outputs against each other, from an empty mismatch
    list; records output_gb."""
    res["writer_mismatch"] = []
    if len(outs) != 2:
        res["outputs_equal"] = False
        return
    if writer == "digest":
        mismatch, missing = compare_digests(outs["streamed"],
                                            outs["in_memory"])
        res["writer_mismatch"], res["digest_missing"] = mismatch, missing
        res["outputs_equal"] = res["streamed_equals_inmemory_digest"] = (
            not mismatch and not missing)
        res["digest_levels"] = sum(len(v) for v in outs["streamed"].values())
    else:
        res["writer_mismatch"] = compare_files(outs["streamed"],
                                               outs["in_memory"])
        res["outputs_equal"] = res["streamed_equals_inmemory_file"] = (
            not res["writer_mismatch"])
        res["output_gb"] = os.path.getsize(outs["streamed"]) / 1e9
        if not keep_outputs:
            for p in outs.values():
                os.unlink(p)
    print(f"- outputs equal ({writer}): {res['outputs_equal']}", flush=True)


def fetch_probe(timeout=600):
    """In a child: one 256-MiB device -> host copy, pageable
    (``Tensor.cpu()``) and into a pinned buffer, after a warm-up of each;
    {"pageable_gbps", "pinned_gbps", ...} or {"error": ...}."""
    code = """\
import json, time, torch
dev = torch.device("cuda", 0)
x = torch.ones(256 * 2**20 // 4, device=dev)
pinned = torch.empty(x.shape, pin_memory=True)
torch.cuda.synchronize()
out = {"bytes": x.numel() * 4}
for name, copy in (("pageable", lambda: x.cpu()),
                   ("pinned", lambda: pinned.copy_(x))):
    copy()
    torch.cuda.synchronize()
    t = time.perf_counter()
    copy()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    out[name + "_s"] = dt
    out[name + "_gbps"] = out["bytes"] / dt / 1e9
print("PROBE", json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    try:
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": "timeout"}
    for line in r.stdout.splitlines():
        if line.startswith("PROBE "):
            return json.loads(line[6:])
    return {"error": f"rc={r.returncode} {r.stderr[-300:]}"}


def run_production(cache_dir, writer, ncells=NCELLS, nz=NZ, nx=NX, ny=NY,
                   res=None, keep_outputs=False, timeout=7200):
    """Inputs (cached), the warm-up, both children, the comparison and,
    on a CUDA platform, the fetch probe, into ``res`` (a fresh artifact,
    or an old one whose measurements are replaced). Returns (res, the
    inputs' directory)."""
    platform = os.environ.get("MPASSIT_PLATFORM", "cuda")
    t0 = time.perf_counter()
    d = build_inputs(cache_dir, ncells, nz)
    res = {} if res is None else res
    res.update({
        "tool": "mpassit_tpu_torch.tools.bench_production",
        "ncells": ncells, "nz": nz, "nsoil": NSOIL,
        "grid": f"{nx}x{ny} lambert {DX * NX / nx / 1000:g}km CONUS",
        "n_cols": 18 + nz + 3 + 2 + 1 + 11 * nz + 2 * (nz + 1) + nz
        + 2 * nz + 3 * NSOIL,
        "varlists": "parm/ defaults + vorticity (vertex path)",
        "input_gb": sum(os.path.getsize(os.path.join(d, f))
                        for f in ("grid.nc", "hist.nc", "diag.nc")) / 1e9,
        "input_format": "CDF-2, record Time",
        "inputs_s": time.perf_counter() - t0,
        "writer": writer, "platform": platform,
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "measurement": "each run in its own subprocess (process-cold, "
                       "weights cache and kernel libraries warm: the "
                       "production cadence of one process per forecast "
                       "hour), one after the other on one device",
    })
    reduced = [f"{k} {v} < {full} (tools/bench_production.py)"
               for k, v, full in (("ncells", ncells, NCELLS), ("nz", nz, NZ),
                                  ("nx", nx, NX), ("ny", ny, NY))
               if v < full]
    res.pop("reduced", None)
    if reduced:
        res["reduced"] = reduced
    shape = (nx, ny)
    t = time.perf_counter()
    nml = os.path.join(d, "namelist.warm")
    with open(nml, "w") as f:
        f.write(_namelist_text(d, cache_dir, os.path.join(d, "unused.nc"),
                               True, *shape))
    res["warm_weights"] = warm_cache(nml)
    res["warm_cache_s"] = time.perf_counter() - t
    if platform == "cuda":
        t = time.perf_counter()
        res["kernel_build"] = build_kernels()
        res["kernel_build_s"] = time.perf_counter() - t
        from .kernel_variants import _card

        res["card"] = _card()
    outs = _rss_runs(d, cache_dir, res, writer, shape, timeout=timeout)
    _compare(outs, res, writer, keep_outputs)
    wall = res["subprocess_wall_s"]
    res["t_pipeline_streamed_s"] = wall.get("streamed")
    res["t_pipeline_inmem_s"] = wall.get("in_memory")
    res["fetch_probe"] = (fetch_probe() if platform == "cuda" else
                          {"skipped": "MPASSIT_PLATFORM=cpu: no device"})
    res["ok"] = bool(res["outputs_equal"] and not res.get("rss_run_errors"))
    return res, d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--writer", required=True, choices=("netcdf4", "digest"))
    ap.add_argument("--ncells", type=int, default=NCELLS)
    ap.add_argument("--nz", type=int, default=NZ)
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--ny", type=int, default=NY)
    ap.add_argument("--cache-dir", default=os.path.join(REPO, ".bench_cache"))
    ap.add_argument("--out", default=None,
                    help="artifact path (default: <cache-dir>/"
                         "production_e2e_torch.json)")
    ap.add_argument("--rss-only", action="store_true",
                    help="rerun the children into the existing artifact")
    ap.add_argument("--timeout", type=float, default=7200,
                    help="seconds per child")
    args = ap.parse_args(argv)
    platform = os.environ.get("MPASSIT_PLATFORM", "cuda")
    if platform == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("bench_production: MPASSIT_PLATFORM=cuda but "
                  "torch.cuda.is_available() is False (set "
                  "MPASSIT_PLATFORM=cpu to run on the CPU)", file=sys.stderr)
            return 1
    out = args.out or os.path.join(args.cache_dir, "production_e2e_torch.json")
    res = None
    if args.rss_only:
        with open(out) as f:
            res = json.load(f)
    res, _ = run_production(args.cache_dir, args.writer, args.ncells,
                            args.nz, args.nx, args.ny, res=res,
                            timeout=args.timeout)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    print(f"- written to {out}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
