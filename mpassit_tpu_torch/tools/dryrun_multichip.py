"""Dry run of the port's multi-device path over N ranks (counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``).

    python -m mpassit_tpu_torch.tools.dryrun_multichip [--ranks N]
        [--platform cuda|cpu] [--ncells N] [--nx N] [--ny N] [--timeout S]

The ranks run on the cards, one card each, unless the caller asks for the
CPU: ``--platform`` defaults to ``MPASSIT_PLATFORM``, which defaults to
``cuda``, as the CLI's does. A CUDA run with fewer cards than ranks fails;
it never moves to the CPU.

The parent builds a small problem with the port's own host layers: a
synthetic MPAS mesh in Morton order, a Lambert grid whose tile rows are
not a multiple of the rank count by default (150 rows: 5 tile rows), the
bilinear, nearest, conservative, vertex and EDGE1 operators and seeded
sources. Then N processes (``torch.multiprocessing``, spawn) start one
process group through ``parallel/multihost.maybe_init_distributed`` (NCCL
with one card per rank; gloo under ``--platform cpu``), and
each rank runs:

- every operator through ``ShardedRegridder`` (replicated source) and
  ``SourceShardedRegridder`` with ``comm`` ring and allgather, float64;
- ``ring_apply`` and ``shard_map_apply`` on the bilinear operator, 2-D and
  1-D sources;
- the tile-row-sharded ``PackedSlabRegridder`` over one operator
  (bilinear, vertex, EDGE1) and over three (bilinear + nearest +
  conservative, the Q4 rotation in the kernel), float32: in one pass, in
  column groups (a tiny ``MPASSIT_DEVICE_BUDGET_GB``), with ``root_only``
  and into a strip sink; and once on the one-hot route
  (``MPASSIT_ELL_KERNEL=0``, split6_bf16).

The parent holds every rank's results against the unsharded applies run
in its own process: replicate and the tile-row-sharded applies bit for
bit, ring and allgather within 1e-13 (rtol and atol, float64); every
rank's gather-to-all result equal to rank 0's; root-only results zero off
rank 0. It prints one JSON summary line and exits 1 when a check fails.
Each run of the ranks has a time limit, past which they are killed.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np

#: packed columns per method (bilinear, nearest, conserve): 640 padded
#: columns, more than one FETCH group, so a tiny budget groups the apply
PACK_COLS = (520, 60, 40)
#: the Q4 rotation window of the packed apply: u at [0, 3), v at [3, 6)
ROTATE = (0, 3, 3)
#: columns of the float64 and slab applies
NCOL = 5
TOL_F64 = 1e-13
#: MPASSIT_DEVICE_BUDGET_GB of the grouped run: below any pack here
TINY_BUDGET = "0.001"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(fn, world: int, args, timeout: float) -> None:
    """``fn(rank, world, *args)`` in ``world`` spawned processes. Raises
    when a rank fails, and kills every rank still running when they have
    not all finished within ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world,) + tuple(args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(5)


def build_problem(ncells: int, nx: int, ny: int, seed: int = 0) -> dict:
    """The operators (ELLWeights by name) and sources of the dry run."""
    from ..config import Config
    from ..grids.target import build_target_grid
    from ..mesh.reorder import reorder_cells_morton
    from ..mesh.synthetic import synthetic_voronoi_mesh
    from ..weights.bilinear import bilinear_cell_weights, \
        bilinear_vertex_weights
    from ..weights.conservative import conservative_weights
    from ..weights.nearest import nearest_weights
    from ..weights.restagger import edge1_weights

    cfg = Config.from_dict({
        "target_grid_type": "lambert", "nx": nx + 1, "ny": ny + 1,
        "dx": 60e3, "dy": 60e3, "ref_lat": 38.5, "ref_lon": -97.5,
        "truelat1": 38.5, "stand_lon": -97.5})
    grid = build_target_grid(cfg)
    mesh = synthetic_voronoi_mesh(ncells=ncells, nz=3, nsoil=1, seed=11)
    mesh = reorder_cells_morton(mesh, grid.proj).mesh
    ells = {
        "bilinear": bilinear_cell_weights(mesh, grid.lat, grid.lon),
        "nearest": nearest_weights(mesh, grid.lat, grid.lon),
        "conserve": conservative_weights(mesh, grid),
        "vertex": bilinear_vertex_weights(mesh, grid.lat, grid.lon),
        "edge1": edge1_weights(grid),
    }
    rng = np.random.default_rng(seed)
    # the packed apply reads the bilinear source's every column
    src = {k: rng.standard_normal(
               (e.n_src, sum(PACK_COLS) if k == "bilinear" else NCOL))
           for k, e in ells.items()}
    alpha = rng.uniform(-0.3, 0.3, grid.shape)
    return {"ells": ells, "src": src,
            "cosa": np.cos(alpha).astype(np.float32),
            "sina": np.sin(alpha).astype(np.float32)}


def save_problem(prob: dict, path: str) -> None:
    arrs = {"cosa": prob["cosa"], "sina": prob["sina"]}
    for k, e in prob["ells"].items():
        arrs.update({f"{k}.idx": e.idx, f"{k}.w": e.w,
                     f"{k}.shape": np.asarray(e.dst_shape),
                     f"{k}.meta": np.asarray([e.n_src]),
                     f"{k}.src": prob["src"][k]})
    np.savez(path, **arrs)


def load_problem(path: str) -> dict:
    from ..weights.ell import ELLWeights

    with np.load(path) as z:
        names = sorted({k.split(".")[0] for k in z.files if "." in k})
        return {"ells": {k: ELLWeights(
                    z[f"{k}.idx"], z[f"{k}.w"], int(z[f"{k}.meta"][0]), k,
                    tuple(int(v) for v in z[f"{k}.shape"])) for k in names},
                "src": {k: z[f"{k}.src"] for k in names},
                "cosa": z["cosa"], "sina": z["sina"]}


def applies(prob: dict, device, mesh) -> dict:
    """Every apply of the dry run on ``device``, sharded over ``mesh``
    (None: the unsharded engines), as {name: host array}."""
    import torch

    from ..ops.apply import Regridder
    from ..ops.matmul_apply import PackedSlabRegridder, padded
    from ..parallel.sharding import (
        ShardedRegridder,
        SourceShardedRegridder,
        ring_apply,
        shard_map_apply,
    )

    ells, src = prob["ells"], prob["src"]
    f64 = torch.float64
    out = {}
    for k, e in ells.items():
        s = src[k][:, :NCOL]
        if mesh is None:
            ref = Regridder(e, device, dtype=f64).apply_np(s)
            out.update({f"{m}.{k}": ref
                        for m in ("replicate", "ring", "allgather")})
        else:
            out[f"replicate.{k}"] = ShardedRegridder(
                e, mesh, dtype=f64).apply_np(s)
            for comm in ("ring", "allgather"):
                out[f"{comm}.{k}"] = SourceShardedRegridder(
                    e, mesh, dtype=f64, comm=comm).apply_np(s)
    bil, s = ells["bilinear"], src["bilinear"][:, :NCOL]
    for one_d in (False, True):
        x = s[:, 0] if one_d else s
        tag = "_1d" if one_d else ""
        if mesh is None:
            ref = Regridder(bil, device, dtype=f64).apply_np(x).reshape(
                (bil.n_dst,) + x.shape[1:])
            out[f"ring_apply{tag}"] = out[f"shard_map_apply{tag}"] = ref
        else:
            out[f"ring_apply{tag}"] = ring_apply(bil, mesh, x, dtype=f64)
            out[f"shard_map_apply{tag}"] = shard_map_apply(bil, mesh, x,
                                                           dtype=f64)
    for k in ("bilinear", "vertex", "edge1"):
        out[f"slab.{k}"] = PackedSlabRegridder([ells[k]], device,
                                               mesh=mesh).apply_np(
            src[k][:, :NCOL].astype(np.float32))
    cell = [ells[k] for k in ("bilinear", "nearest", "conserve")]
    rotation = (prob["cosa"], prob["sina"])
    pk = PackedSlabRegridder(cell, device, rotation=rotation, mesh=mesh)
    sp = src["bilinear"].astype(np.float32)
    cols, rot = PACK_COLS, (ROTATE,)
    out["packed"] = pk.apply_np(sp, cols, rot)
    os.environ["MPASSIT_DEVICE_BUDGET_GB"] = TINY_BUDGET
    try:
        out["packed_group_width"] = np.asarray(
            pk._grouped_width(padded(sum(cols)), rot))
        out["packed_grouped"] = pk.apply_np(sp, cols, rot)
        strips = {}
        pk.apply_np([sp[:, :7], sp[:, 7:]], cols, rot,
                    strip_sink=lambda lo, st: strips.__setitem__(
                        lo, np.array(st)))
        out["packed_grouped_sink"] = (np.concatenate(
            [strips[lo] for lo in sorted(strips)], axis=2) if strips
            else np.zeros((0,)))
    finally:
        del os.environ["MPASSIT_DEVICE_BUDGET_GB"]
    out["packed_root_only"] = np.array(pk.apply_np(sp, cols, rot,
                                                   root_only=True))
    os.environ["MPASSIT_ELL_KERNEL"] = "0"
    try:
        out["packed_onehot"] = PackedSlabRegridder(
            cell, device, precision="split6_bf16", rotation=rotation,
            mesh=mesh).apply_np(sp, cols, rot)
    finally:
        del os.environ["MPASSIT_ELL_KERNEL"]
    return out


def _rank_main(rank, world, port, problem_path, out_dir, platform):
    """One rank: the process group from the MPASSIT_* variables, every
    apply sharded over it, the results saved as ``rank<r>.npz``."""
    os.environ.update({"MPASSIT_COORDINATOR": f"localhost:{port}",
                       "MPASSIT_NUM_PROCESSES": str(world),
                       "MPASSIT_PROCESS_ID": str(rank)})
    import torch

    from ..parallel.multihost import (
        maybe_init_distributed,
        shutdown_distributed,
    )
    from ..parallel.sharding import make_grid_mesh

    torch.set_num_threads(1)
    device = (torch.device("cuda", rank) if platform == "cuda"
              else torch.device("cpu"))
    maybe_init_distributed(device)
    try:
        res = applies(load_problem(problem_path), device,
                      make_grid_mesh(device))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        shutdown_distributed()


def check_platform(platform: str, world: int) -> None:
    """Raise unless ``platform`` is ``cpu``, or ``cuda`` with at least
    ``world`` cards."""
    import torch

    if platform not in ("cpu", "cuda"):
        raise ValueError(f"platform {platform!r}: expected 'cuda' or 'cpu'")
    if platform == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"{world} ranks need as many CUDA devices, "
            f"{torch.cuda.device_count()} present (--platform cpu runs "
            "them on the CPU)")


def run(world: int, prob: dict, platform: str = "cuda",
        timeout: float = 300) -> tuple:
    """The dry run: (summary dict, {rank: results}, unsharded results)."""
    import torch

    check_platform(platform, world)
    t0 = time.perf_counter()
    device = torch.device("cuda", 0) if platform == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "problem.npz")
        save_problem(prob, path)
        run_ranks(_rank_main, world, (free_port(), path, d, platform),
                  timeout)
        ranks = {}
        for r in range(world):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                ranks[r] = {k: z[k] for k in z.files}
    ref = applies(prob, device, None)
    return summarize(world, platform, ref, ranks, t0), ranks, ref


def summarize(world, platform, ref, ranks, t0) -> dict:
    """The checks of the module docstring, by name, with the float64
    source-sharded applies' largest relative differences."""
    r0 = ranks[0]
    checks, rel = {}, {}
    for k, want in ref.items():
        got = r0[k]
        if k.startswith(("ring", "allgather", "shard_map")):
            checks[k] = bool(got.shape == want.shape and np.allclose(
                got, want, rtol=TOL_F64, atol=TOL_F64))
            rel[k] = float(np.abs(got - want).max()
                           / max(float(np.abs(want).max()), 1e-300))
        else:
            checks[k] = bool(np.array_equal(got, want))
    checks["grouped"] = bool(0 < int(r0["packed_group_width"])
                             < sum(PACK_COLS))
    checks["root_only_zero_off_rank_0"] = all(
        not ranks[r]["packed_root_only"].any() for r in ranks if r)
    checks["every_rank_equal_rank_0"] = all(
        np.array_equal(ranks[r][k], r0[k]) for r in ranks
        for k in r0 if k != "packed_root_only")
    return {"tool": "dryrun_multichip", "ranks": world,
            "backend": "nccl" if platform == "cuda" else "gloo",
            "platform": platform, "n_checks": len(checks),
            "failed": sorted(k for k, v in checks.items() if not v),
            "f64_source_sharded_max_rel": max(rel.values()),
            "tol_f64": TOL_F64, "t_s": time.perf_counter() - t0,
            "ok": all(checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--platform", choices=("cuda", "cpu"),
                    default=os.environ.get("MPASSIT_PLATFORM", "cuda"))
    ap.add_argument("--ncells", type=int, default=3000)
    ap.add_argument("--nx", type=int, default=40)
    ap.add_argument("--ny", type=int, default=150)
    ap.add_argument("--timeout", type=float, default=300)
    args = ap.parse_args(argv)
    try:
        check_platform(args.platform, args.ranks)
    except (ValueError, RuntimeError) as e:
        print(f"dryrun_multichip: {e}", file=sys.stderr)
        return 1
    prob = build_problem(args.ncells, args.nx, args.ny)
    summary, _, _ = run(args.ranks, prob, args.platform, args.timeout)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
