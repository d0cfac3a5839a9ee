"""Two OS processes run the port's CLI (``python -m mpassit_tpu_torch``,
MPASSIT_PLATFORM=cpu) as one gloo process group from the MPASSIT_*
variables, with n_device_shards = -1: the port's counterpart of
tests/test_multiprocess.py and of the reference's ``mpirun -n 2 mpassit``
(mpassit.F90:71-96, the rank-0 write of write_data.F90:1005-1475). Each
case mirrors that file's, against the JAX package's single-process run at
its tolerances:

- ring and replicate: rank 0's file within rtol 2e-5, atol 1e-4;
- f64 through MPASSIT_DUMP_RESULT: within 1e-12 of the JAX run; the
  replicate engine also bit for bit the port's own single-process f64 run;
- fetch_root_only: rank 0's file equal to the gather-to-all run's;
- stream_output: equal to the in-memory two-process file, with empty
  dumps on both ranks (no rank held the output) and rank 1 dropping its
  strips.

Every launch of the pair has its own time limit, past which both
processes' sessions are killed."""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpassit_tpu.io.nc4 import open_dataset
from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.config import Config as PortConfig
from mpassit_tpu_torch.run import pipeline as tpipe

from test_multiprocess import _free_port, _write_namelist
from test_pipeline import make_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATS = ("diag2d", "diag3d", "patch2d", "nz3d", "nzp13d", "vert3d", "cons2d",
        "nstd2d", "soil")
FILE_TOL = dict(rtol=2e-5, atol=1e-4)
TIMEOUT_S = 300


def _launch_two(nml, tmp_path, extra_env=None):
    """Both ranks of the CLI on ``nml``; returns their combined output.
    Past TIMEOUT_S both sessions are killed and the test fails."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.update(MPASSIT_PLATFORM="cpu", OMP_NUM_THREADS="2",
                   MPASSIT_COORDINATOR=f"localhost:{port}",
                   MPASSIT_NUM_PROCESSES="2", MPASSIT_PROCESS_ID=str(pid))
        env.update({k: v.format(pid=pid)
                    for k, v in (extra_env or {}).items()})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mpassit_tpu_torch", str(nml)],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, start_new_session=True))
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1, deadline - time.monotonic()))
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{text[-3000:]}"
    return outs


def _arrays(res):
    out = {}
    for cat in CATS:
        for name, arr, *_ in getattr(res, cat, None) or []:
            out[f"{cat}.{name}"] = arr
    for name in ("u", "v", "hgt"):
        out[name] = getattr(res, name)
    return out


def _files_close(ref_file, got_file, exact=False):
    with open_dataset(ref_file) as fr, open_dataset(got_file) as fg:
        assert set(fg.var_names()) == set(fr.var_names())
        for name in fr.var_names():
            a, b = fr.read_var(name), fg.read_var(name)
            assert a.shape == b.shape, name
            if exact:
                np.testing.assert_array_equal(b, a, err_msg=name)
            elif a.dtype.kind in "fc":
                np.testing.assert_allclose(b, a, err_msg=name, **FILE_TOL)
            else:
                assert (a == b).all(), name
        assert fg.get_attr("MAP_PROJ") == fr.get_attr("MAP_PROJ")


@pytest.mark.parametrize("source_decomp", ["ring", "replicate"])
def test_two_process_pipeline_matches_single(tmp_path, source_decomp):
    mesh, cfg, _, _ = make_case(tmp_path, ncells=900, nx=17, ny=13)
    jax_run(cfg, dtype=jnp.float32)
    nml = tmp_path / "namelist.mp"
    mp_out = str(tmp_path / "out_mp.nc")
    _write_namelist(nml, cfg, mp_out, source_decomp)
    outs = _launch_two(nml, tmp_path)
    assert "process 0 of 2, gloo on cpu" in outs[0]
    assert "process 1 of 2, gloo on cpu" in outs[1]
    _files_close(cfg.output_file, mp_out)


@pytest.mark.parametrize("source_decomp", ["ring", "replicate"])
def test_two_process_f64_bit_parity(tmp_path, source_decomp):
    """Agreement at compute precision: the f64 dump of rank 0 within
    1e-12 of the JAX package's single-process f64 run; on the replicate
    engine (each target row's sum as on one process) bit for bit the
    port's own single-process f64 run."""
    mesh, cfg, _, _ = make_case(tmp_path, ncells=900, nx=17, ny=13)
    jax.config.update("jax_enable_x64", True)
    ref = _arrays(jax_run(cfg, dtype=jnp.float64).result)
    nml = tmp_path / "namelist.f64"
    dump = str(tmp_path / "res_f64.npz")
    _write_namelist(nml, cfg, str(tmp_path / "out_f64.nc"), source_decomp,
                    extra=" compute_dtype = 'float64'\n")
    _launch_two(nml, tmp_path, extra_env={"MPASSIT_DUMP_RESULT": dump})
    pcfg = PortConfig.from_namelist(str(nml))
    pcfg.n_device_shards = 0
    pcfg.output_file = str(tmp_path / "out_single.nc")
    single = _arrays(tpipe.run_pipeline(pcfg, "cpu").result)
    with np.load(dump) as z:
        assert set(z.files) == set(ref)
        for k in z.files:
            assert z[k].dtype == np.float64, k
            np.testing.assert_allclose(z[k], ref[k], rtol=1e-12, atol=1e-12,
                                       err_msg=k)
            if source_decomp == "replicate":
                np.testing.assert_array_equal(z[k], single[k], err_msg=k)
            else:
                np.testing.assert_allclose(z[k], single[k], rtol=1e-12,
                                           atol=1e-12, err_msg=k)


def test_two_process_root_only_fetch(tmp_path):
    """fetch_root_only: the terminal fields are gathered to rank 0 only;
    its file equals the gather-to-all run's."""
    mesh, cfg, _, _ = make_case(tmp_path, ncells=900, nx=17, ny=13)
    out_a, out_r = str(tmp_path / "out_all.nc"), str(tmp_path / "out_root.nc")
    _write_namelist(tmp_path / "namelist.all", cfg, out_a, "ring")
    _launch_two(tmp_path / "namelist.all", tmp_path)
    _write_namelist(tmp_path / "namelist.root", cfg, out_r, "ring",
                    extra=" fetch_root_only = .true.\n")
    _launch_two(tmp_path / "namelist.root", tmp_path)
    _files_close(out_a, out_r, exact=True)


def test_two_process_streamed_output(tmp_path):
    """stream_output on two ranks: rank 0 writes through the
    StreamingWriter, rank 1 joins every strip's gather with a
    NullStreamWriter; the file equals the in-memory two-process file and
    matches the JAX single-process run, and neither rank held the output
    (both dumps empty)."""
    mesh, cfg, _, _ = make_case(tmp_path, ncells=900, nx=17, ny=13)
    jax_run(cfg, dtype=jnp.float32)
    out_m, out_s = str(tmp_path / "out_mem.nc"), str(tmp_path / "out_st.nc")
    _write_namelist(tmp_path / "namelist.mem", cfg, out_m, "replicate")
    _launch_two(tmp_path / "namelist.mem", tmp_path)
    _write_namelist(tmp_path / "namelist.stream", cfg, out_s, "replicate",
                    extra=" stream_output = .true.\n")
    dump = str(tmp_path / "res_stream_{pid}.npz")
    outs = _launch_two(tmp_path / "namelist.stream", tmp_path,
                       extra_env={"MPASSIT_DUMP_RESULT": dump})
    assert "drops them (no full-output buffer)" in outs[1]
    for pid in range(2):
        with np.load(dump.format(pid=pid)) as z:
            assert list(z.files) == [], (pid, list(z.files))
    _files_close(out_m, out_s, exact=True)
    _files_close(cfg.output_file, out_s)
