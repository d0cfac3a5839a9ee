"""Kernel-structure experiment of the ELL apply on one CUDA card.

    python -m mpassit_tpu_torch.tools.kernel_variants [--ncells N]
        [--cols 512] [--seed 0] [--cache-dir DIR]

Counterpart of ``tools/kernel_variants.py``. On the full-mesh problem (a
synthetic global mesh of ``--ncells`` cells, 2.6M by default, mapped to the
1801x1061 3-km CONUS Lambert grid) it times, on one seeded (ncells, cols)
source and one slab gathered from it:

- v0: ``packed_apply`` (csrc/packed_apply.cu), the ELL-direct kernel of the
  main path, f32 sums;
- v1: ``ell_split_apply_v1``, the one-hot operator built from the ELL arrays
  in the kernel, split_bf16 terms summed as three products;
- v2: ``ell_split_apply_v2`` at CC = 128 and 256 columns per chunk, the
  operator built once per 32 target points and reused for every chunk;
- the write wall: ``write_wall`` at the same output shape, the store-only
  ceiling each variant is set against.

Each is timed by CUDA events, the median of 10 launches after a warm-up,
and reported in ms, point-values/s and as a multiple of the write wall's
time. Spot checks: v1 against v2 (within 1e-6 of max|v1|: the same
terms in another order) and v1 against v0 (within 3e-5 of max|v0|: v0 sums
in plain f32, so the difference is the dropped lo x lo term of split_bf16).
Output is one JSON line per variant, one for the checks and a final
summary line; the exit code is 1 without a CUDA device or when a check
fails.

The problem is built with the shared host layers only (no JAX): the
configuration of ``bench.build_conus_problem``, its on-disk mesh cache, the
Morton renumbering and the ``WeightCache``. Only the bilinear operator is
built; the JAX tool also builds nearest and conservative weights that it
never uses. Nor is its ``fori_loop`` and checksum harness copied: its own
docstring records that XLA hoisted the loop-invariant kernel out of it.
Eager launches timed by CUDA events have no such trap.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: launches timed per variant (their median is reported)
REPS = 10
#: v1 vs v2, relative to max|v1| (the same terms, another f32 sum order)
TOL_V1_V2 = 1e-6
#: v1 vs v0, relative to max|v0| (split_bf16 drops lo x lo: ~2^-16 relative
#: per product, times the operator's sum of |w| <= 1 for bilinear)
TOL_V1_V0 = 3e-5


def _cached_mesh(cache_dir, ncells, nz, nsoil, seed=1):
    """Synthetic mesh memoized to disk in bench.py's format and file name
    (SphericalVoronoi at 2.6M cells is minutes of host time)."""
    from mpassit_tpu.mesh.mpas import MPASMesh
    from mpassit_tpu.mesh.synthetic import synthetic_voronoi_mesh

    path = os.path.join(cache_dir, f"mesh_{ncells}_{nz}_{nsoil}_{seed}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return MPASMesh(
            ncells=int(z["ncells"]), nvertices=int(z["nvertices"]),
            nz=nz, nzp1=nz + 1, max_edges=int(z["max_edges"]), nsoil=nsoil,
            lat_cell=z["lat_cell"], lon_cell=z["lon_cell"],
            lat_vertex=z["lat_vertex"], lon_vertex=z["lon_vertex"],
            vertices_on_cell=z["voc"], cells_on_vertex=z["cov"],
            ter=z["ter"], zs=z["zs"])
    mesh = synthetic_voronoi_mesh(ncells=ncells, nz=nz, nsoil=nsoil,
                                  seed=seed)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, ncells=mesh.ncells, nvertices=mesh.nvertices,
             max_edges=mesh.max_edges, lat_cell=mesh.lat_cell,
             lon_cell=mesh.lon_cell, lat_vertex=mesh.lat_vertex,
             lon_vertex=mesh.lon_vertex, voc=mesh.vertices_on_cell,
             cov=mesh.cells_on_vertex, ter=mesh.ter, zs=mesh.zs)
    os.replace(tmp, path)
    return mesh


def build_problem(ncells, nx, ny, cache_dir, nz=2, nsoil=1):
    """The bilinear operator of a synthetic ``ncells`` mesh, Morton
    renumbered, onto an nx x ny Lambert grid at bench.py's 3-km CONUS
    settings (dx scaled by 1801/nx). Returns (ell, info)."""
    from mpassit_tpu.config import Config
    from mpassit_tpu.grids.target import build_target_grid
    from mpassit_tpu.mesh.reorder import reorder_cells_morton
    from mpassit_tpu.weights.bilinear import bilinear_cell_weights
    from mpassit_tpu.weights.cache import WeightCache, grid_fingerprint

    cfg = Config.from_dict({
        "target_grid_type": "lambert", "nx": nx + 1, "ny": ny + 1,
        "dx": 3000.0 * (1801 / nx), "dy": 3000.0 * (1801 / nx),
        "ref_lat": 38.5, "ref_lon": -97.5, "truelat1": 38.5,
        "stand_lon": -97.5,
    })
    cfg.weights_cache_dir = cache_dir          # the grid cache rides along
    t0 = time.perf_counter()
    grid = build_target_grid(cfg)
    mesh = _cached_mesh(cache_dir, ncells, nz, nsoil)
    mesh = reorder_cells_morton(mesh, grid.proj).mesh
    t_setup = time.perf_counter() - t0
    cache = WeightCache(cache_dir)
    fpm, fpg = mesh.fingerprint(), grid_fingerprint(grid)
    warm = cache.has("bilinear", fpm, fpg)
    t0 = time.perf_counter()
    ell = cache.get_or_build(
        "bilinear", fpm, fpg,
        lambda: bilinear_cell_weights(mesh, grid.lat, grid.lon))
    return ell, {"ncells": mesh.ncells, "ny": grid.ny, "nx": grid.nx,
                 "setup_s": t_setup, "weights": "warm" if warm else "cold",
                 "weights_s": time.perf_counter() - t0}


def _time_ms(fn):
    """Median ms of REPS launches by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return sorted(ts)[len(ts) // 2]


def _max_rel(a, b):
    """(max|a - b|, that over max|b|)."""
    d = float((a - b).abs().max())
    return d, d / max(float(b.abs().max()), 1e-30)


def run_variants(ell, device, *, cols=512, seed=0, cache_dir=None):
    """v0, v1, v2 (CC 128 and 256 where they divide the padded width) and
    the write wall on the operator ``ell`` and a seeded (n_src, cols)
    source on ``device``. On a CUDA device every variant is timed; on the
    CPU (tests) the wrappers run their plain versions and nothing is timed.
    Returns {"problem", "variants", "checks", "ok"}."""
    from ..ops.matmul_apply import LANE, SlabMatmulRegridder
    from ..ops.packed_kernel import packed_apply
    from ..ops.variant_kernels import (
        V2_CC,
        ell_split_apply_v1,
        ell_split_apply_v2,
    )
    from ..ops.write_wall import write_wall

    device = torch.device(device)
    rg = SlabMatmulRegridder(ell, device, precision="split_bf16",
                             cache_dir=cache_dir)
    Cp = cols + (-cols) % LANE
    rng = np.random.default_rng(seed)
    src = torch.zeros((ell.n_src, Cp), dtype=torch.float32, device=device)
    src[:, :cols] = torch.from_numpy(
        rng.standard_normal((ell.n_src, cols)).astype(np.float32)).to(device)
    slab = rg._slab(src)
    del src
    (loc,), (w,) = rg._ell_dev()
    row = torch.from_numpy(
        rng.standard_normal((1, 1, Cp)).astype(np.float32)).to(device)
    nt = dict(nty=rg.nty, ntx=rg.ntx)
    calls = {
        "v0": ("packed_apply", lambda: packed_apply(
            slab, (loc,), (w,), ranges=((0, Cp),), **nt)),
        "v1": ("ell_split_apply_v1", lambda: ell_split_apply_v1(
            loc, w, slab, **nt)),
    }
    for cc in V2_CC:
        if Cp % cc == 0:
            calls[f"v2_cc{cc}"] = ("ell_split_apply_v2",
                                   lambda cc=cc: ell_split_apply_v2(
                                       loc, w, slab, CC=cc, **nt))
    wall = ("write_wall", lambda: write_wall(row, **nt))

    # one run of each for the spot checks, then the timings
    outs = {name: fn() for name, (_, fn) in calls.items()}
    wall_out = wall[1]()
    checks = {"tol_v1_v2": TOL_V1_V2, "tol_v1_v0": TOL_V1_V0,
              "write_wall_rows_equal_seed": bool(torch.equal(
                  wall_out, row.expand_as(wall_out)))}
    del wall_out
    for name in [n for n in outs if n.startswith("v2")]:
        checks[f"v1_vs_{name}_max_abs_diff"], checks[
            f"v1_vs_{name}_rel"] = _max_rel(outs[name], outs["v1"])
    checks["v1_vs_v0_max_abs_diff"], checks["v1_vs_v0_rel"] = _max_rel(
        outs["v1"], outs["v0"])
    checks["finite"] = all(bool(torch.isfinite(o).all())
                           for o in outs.values())
    del outs
    ok = (checks["finite"] and checks["write_wall_rows_equal_seed"]
          and checks["v1_vs_v0_rel"] <= TOL_V1_V0
          and all(v <= TOL_V1_V2 for k, v in checks.items()
                  if k.startswith("v1_vs_v2") and k.endswith("_rel")))
    checks["ok"] = ok

    ny, nx = rg.dst_shape
    out_bytes = rg.nty * 32 * rg.ntx * 32 * Cp * 4
    problem = {"n_src": ell.n_src, "ny": ny, "nx": nx, "nty": rg.nty,
               "ntx": rg.ntx, "n_tiles": rg.n_tiles, "W": rg.W,
               "K": int(loc.shape[1]), "cols": cols, "Cp": Cp,
               "device": str(device), "out_bytes": out_bytes,
               "fma_per_split_variant": rg.n_tiles * 1024 * rg.W * Cp * 3}
    variants = []
    timed = device.type == "cuda"
    wall_ms = _time_ms(wall[1]) if timed else None
    for name, (kernel, fn) in calls.items():
        rec = {"variant": name, "kernel": kernel}
        if timed:
            ms = _time_ms(fn)
            rec.update(ms=ms, point_values_per_s=ny * nx * cols / ms * 1e3,
                       vs_write_wall=ms / wall_ms)
        variants.append(rec)
    rec = {"variant": "write_wall", "kernel": wall[0]}
    if timed:
        rec.update(ms=wall_ms, write_gb_per_s=out_bytes / wall_ms / 1e6)
    variants.append(rec)
    return {"problem": problem, "variants": variants, "checks": checks,
            "ok": ok}


def _card():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ncells", type=int, default=2_600_000)
    ap.add_argument("--cols", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dir", default=os.path.join(REPO, ".bench_cache"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False; the "
              "timings need a CUDA device", file=sys.stderr)
        return 1
    ell, info = build_problem(args.ncells, 1801, 1061, args.cache_dir)
    print(json.dumps({"phase": "problem", **info}), flush=True)
    res = run_variants(ell, torch.device("cuda", 0), cols=args.cols,
                       seed=args.seed, cache_dir=args.cache_dir)
    card = _card()
    for rec in res["variants"]:
        print(json.dumps({**rec, "card": card}), flush=True)
    print(json.dumps({"phase": "checks", **res["checks"]}), flush=True)
    print(json.dumps({
        "tool": "kernel_variants", "card": card, "ok": res["ok"],
        **res["problem"],
        "ms": {r["variant"]: r["ms"] for r in res["variants"]}}), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
