"""The port never imports JAX nor the JAX package: a fresh interpreter
that imports only mpassit_tpu_torch (its pipeline, its own host layers, the
kernel modules and the kernel-variants tool) runs a tiny pipeline on the
CPU on each apply route (default, MPASSIT_ELL_KERNEL=0,
MPASSIT_GATHER_KERNEL=1) and the tool's problem build and variant run, and
finds neither ``jax`` nor any ``mpassit_tpu`` module in sys.modules, nor the
JAX package's ``bench`` or ``tools`` (the production tool, the trace
reader and the multi-rank dry run imported too, and the pipeline run once
more sharded on a mesh of one, replicated and ring); and no source file of the port, nor chip_smoke.py,
names jax, mpassit_tpu, bench or tools in an absolute import."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mpassit_tpu_torch")
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")

SCRIPT = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(2)
from mpassit_tpu_torch.run.pipeline import run_pipeline
from mpassit_tpu_torch.ops import gather_kernel, onehot_kernel
from mpassit_tpu_torch.ops import variant_kernels, write_wall
from mpassit_tpu_torch.tools import bench_production, kernel_variants
from mpassit_tpu_torch.tools import dryrun_multichip, trace_summary
from mpassit_tpu_torch.parallel import sharding
from mpassit_tpu_torch.config import Config
from mpassit_tpu_torch.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_tpu_torch.testing import (
    write_data_file_classic, write_grid_file_classic)

d = sys.argv[1]
mesh = synthetic_voronoi_mesh(ncells=800, nz=3, nsoil=2, seed=5)
write_grid_file_classic(mesh, os.path.join(d, "grid.nc"))
f2 = np.sin(np.deg2rad(mesh.lat_cell))
lev = np.linspace(0, 1, 3)
attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 60.0}
write_data_file_classic(mesh, os.path.join(d, "diag.nc"),
                        {"u10": 5 + f2, "v10": 1 + f2, "t2m": 280 + f2},
                        attrs=attrs, xtime="2024-03-25_10:00:00")
write_data_file_classic(
    mesh, os.path.join(d, "hist.nc"),
    {"skintemp": 285 + f2, "xland": np.where(f2 > 0, 1.0, 2.0),
     "snow": 1 + f2, "theta": 300 + f2[:, None] + lev,
     "uReconstructZonal": 10 + f2[:, None] + lev,
     "uReconstructMeridional": -3 + f2[:, None] + lev,
     "tslb": 275 + f2[:, None] + np.linspace(0, 1, 2)},
    attrs=attrs, xtime="2024-03-25_10:00:00")
for name, body in (("diaglist", "u10 U10\nv10 V10\nt2m T2\n"),
                   ("histlist_2d", "skintemp TSK\nxland XLAND\nsnow SNOW\n"),
                   ("histlist_3d", "theta T\nuReconstructZonal U\n"
                                   "uReconstructMeridional V\n"),
                   ("histlist_soil", "tslb TSLB\n")):
    with open(os.path.join(d, name), "w") as f:
        f.write(body)
cfg = Config.from_dict({
    "grid_file_input_grid": os.path.join(d, "grid.nc"),
    "diag_file_input_grid": os.path.join(d, "diag.nc"),
    "hist_file_input_grid": os.path.join(d, "hist.nc"),
    "output_file": os.path.join(d, "out.nc"), "interp_diag": True,
    "interp_hist": True, "wrf_mod_vars": True, "target_grid_type": "lambert",
    "nx": 21, "ny": 16, "dx": 200e3, "dy": 200e3, "ref_lat": 38.5,
    "ref_lon": -97.5, "truelat1": 38.5, "stand_lon": -97.5,
    "varlist_dir": d})
counts = []
for env in ({}, {"MPASSIT_ELL_KERNEL": "0"}, {"MPASSIT_GATHER_KERNEL": "1"}):
    os.environ.pop("MPASSIT_ELL_KERNEL", None)
    os.environ.pop("MPASSIT_GATHER_KERNEL", None)
    os.environ.update(env)
    art = run_pipeline(cfg, device="cpu")
    assert np.isfinite(art.result.u).all()
    assert art.result.u.shape == (15, 21, 3)
    counts.append((sum(onehot_kernel.PLAIN_CALLS.values()),
                   gather_kernel.PLAIN_CALLS))
assert counts[0] == (0, 0) and counts[1][0] > 0 and counts[2][1] > 0, counts
os.environ.pop("MPASSIT_GATHER_KERNEL", None)
for decomp in ("replicate", "ring"):
    cfg.n_device_shards, cfg.source_decomp = -1, decomp
    art = run_pipeline(cfg, device="cpu")
    assert np.isfinite(art.result.u).all()
ell, _ = kernel_variants.build_problem(2000, 41, 25, os.path.join(d, "kv"))
assert kernel_variants.run_variants(ell, "cpu", cols=128)["ok"]
bound = [m for m in sys.modules
         if m == "jax" or m.startswith(("jax.", "jaxlib"))
         or m == "mpassit_tpu" or m.startswith("mpassit_tpu.")
         or m.split(".")[0] in ("bench", "tools")]
print("BOUND", bound)
assert not bound, bound
print("NO_JAX_OK")
"""


def test_pipeline_runs_without_importing_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert os.path.exists(tmp_path / "out.nc")


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mpassit_tpu", "bench", "tools")


def _sources():
    yield CHIP_SMOKE
    for root, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)


def test_no_source_file_imports_jax():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module or ""]
            offenders += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders
