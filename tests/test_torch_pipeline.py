"""The port's pipeline against the JAX pipeline on the synthetic case of
tests/test_pipeline.make_case: every RegridResult array (f32 within
1e-5 * max(1, max|ref|); f64 rtol 1e-12), the output file's variables and
attributes, the one-hot and in-kernel-gather routes under their switches
(one-hot: 1e-6 * max(1, max|ref|), since JAX's CPU path forms the same
bf16 terms; gather: bit for bit the port's default route), the classic-format (CDF-2) input path chip_smoke.py uses on
machines without h5py, the CLI's exit codes and device rule, and the
sharding options on one process (n_device_shards, source_decomp) and a
one-rank process group."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.io.nc4 import open_dataset
from mpassit_tpu.run.pipeline import run_pipeline as jax_run
from mpassit_tpu_torch.config import Config as PortConfig
from mpassit_tpu_torch.ops import gather_kernel as gk
from mpassit_tpu_torch.ops import onehot_kernel as ok
from mpassit_tpu_torch.ops import packed_kernel as pk
from mpassit_tpu_torch.run import pipeline as tpipe
from mpassit_tpu_torch.testing import (
    write_data_file_classic,
    write_grid_file_classic,
)

from test_pipeline import make_case

CATS = ("diag2d", "diag3d", "patch2d", "nz3d", "nzp13d", "vert3d", "cons2d",
        "nstd2d", "soil")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    """The port's own Config with the fields of the reference's ``cfg``
    (make_case builds the reference's)."""
    return PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)})


def _arrays(res):
    out = {}
    for cat in CATS:
        for name, arr, *_ in getattr(res, cat) or []:
            out[f"{cat}.{name}"] = arr
    for name in ("u", "v", "hgt"):
        if getattr(res, name) is not None:
            out[name] = getattr(res, name)
    return out


def _assert_results_close(got, ref, rtol=None, scale=1e-5):
    a, b = _arrays(got), _arrays(ref)
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        if rtol is None:
            bound = scale * max(1.0, float(np.abs(b[k]).max()))
            err = float(np.abs(np.asarray(a[k], np.float64) - b[k]).max())
            assert err <= bound, (k, err, bound)
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def f32_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe32")
    mesh, cfg, hist, diag = make_case(d)
    ref = jax_run(cfg, jnp.float32)
    jax_out = cfg.output_file
    cfg.output_file = str(d / "out_torch.nc")
    plain = pk.PLAIN_CALLS
    got = tpipe.run_pipeline(_port(cfg), device="cpu")
    n_plain = pk.PLAIN_CALLS - plain
    return d, mesh, cfg, hist, diag, ref, got, jax_out, n_plain


def test_f32_results_match_jax(f32_runs):
    *_, ref, got, _, n_plain = f32_runs
    _assert_results_close(got.result, ref.result)
    for name in ("u", "v", "hgt"):
        assert getattr(got.result, name).dtype == np.float32
    # the default run: one packed apply plus the EDGE1 and EDGE2 restaggers
    # and the vertex field, each one kernel-shaped call (plain on the CPU)
    assert n_plain == 4
    assert set(got.regridders) == set(ref.regridders)


def test_onehot_route_matches_jax(tmp_path, monkeypatch):
    """MPASSIT_ELL_KERNEL=0 under both packages: the port runs the one-hot
    packed kernel's plain version once per apply (the union of the cell
    methods; the EDGE1/EDGE2 restaggers and the vertex field, one
    operator each) and nothing else."""
    monkeypatch.setenv("MPASSIT_ELL_KERNEL", "0")
    mesh, cfg, _, _ = make_case(tmp_path)
    assert cfg.apply_precision == "split6_bf16"
    ref = jax_run(cfg, jnp.float32)
    cfg.output_file = str(tmp_path / "out_torch.nc")
    p0, o0, g0 = pk.PLAIN_CALLS, dict(ok.PLAIN_CALLS), gk.PLAIN_CALLS
    got = tpipe.run_pipeline(_port(cfg), device="cpu")
    assert pk.PLAIN_CALLS == p0 and gk.PLAIN_CALLS == g0
    assert ok.PLAIN_CALLS == {
        "onehot_apply_packed": o0["onehot_apply_packed"] + 4}
    _assert_results_close(got.result, ref.result, scale=1e-6)


def test_gather_route_matches_jax_and_default(tmp_path, monkeypatch,
                                              f32_runs):
    """MPASSIT_GATHER_KERNEL=1: the JAX package gathers in the kernel only
    on a TPU, so its CPU run is its default; the port runs the gather
    kernel's plain version for every apply, bit for bit its default
    route."""
    *_, default, _, _ = f32_runs
    monkeypatch.setenv("MPASSIT_GATHER_KERNEL", "1")
    mesh, cfg, _, _ = make_case(tmp_path)
    ref = jax_run(cfg, jnp.float32)
    cfg.output_file = str(tmp_path / "out_torch.nc")
    p0, o0, g0 = pk.PLAIN_CALLS, dict(ok.PLAIN_CALLS), gk.PLAIN_CALLS
    got = tpipe.run_pipeline(_port(cfg), device="cpu")
    assert gk.PLAIN_CALLS == g0 + 4
    assert pk.PLAIN_CALLS == p0 and ok.PLAIN_CALLS == o0
    _assert_results_close(got.result, ref.result)
    a, b = _arrays(got.result), _arrays(default.result)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_output_file_matches_jax(f32_runs):
    _, _, cfg, *_, jax_out, _ = f32_runs
    with open_dataset(jax_out) as fj, open_dataset(cfg.output_file) as ft:
        assert ft.var_names() == fj.var_names()
        assert ft.global_attr_names() == fj.global_attr_names()
        for a in fj.global_attr_names():
            assert str(ft.get_attr(a)) == str(fj.get_attr(a)), a
        for v in fj.var_names():
            assert ft.var_dims(v) == fj.var_dims(v), v
            assert ft.var_attrs(v).keys() == fj.var_attrs(v).keys(), v
            x, y = ft.read_var(v), fj.read_var(v)
            assert x.shape == y.shape and x.dtype == y.dtype, v
            if x.dtype.kind == "f":
                fin = np.isfinite(y) & (np.abs(y) < 9e36)
                bound = 1e-5 * max(1.0, float(np.abs(y[fin]).max(initial=0)))
                assert np.abs(x[fin] - y[fin]).max(initial=0) <= bound, v
            else:
                np.testing.assert_array_equal(x, y, err_msg=v)


def test_f64_matches_jax(tmp_path):
    mesh, cfg, _, _ = make_case(tmp_path,
                                cfg_overrides={"compute_dtype": "float64"})
    ref = jax_run(cfg, jnp.float64)
    cfg.output_file = str(tmp_path / "out_torch.nc")
    got = tpipe.run_pipeline(_port(cfg), device="cpu")
    assert got.result.u.dtype == np.float64
    _assert_results_close(got.result, ref.result, rtol=1e-12)


@pytest.mark.parametrize("override", [
    {"interp_hist": False, "wrf_mod_vars": False},    # diag-only run
    {"fetch_root_only": True},     # winds leave the packed pass: post-hoc Q4
    {"cell_order": "none"},
])
def test_namelist_variants_match_jax(tmp_path, override):
    mesh, cfg, _, _ = make_case(tmp_path, cfg_overrides=override)
    ref = jax_run(cfg, jnp.float32)
    cfg.output_file = str(tmp_path / "out_torch.nc")
    got = tpipe.run_pipeline(_port(cfg), device="cpu")
    _assert_results_close(got.result, ref.result)


def test_classic_inputs_match_netcdf4_inputs(f32_runs):
    """The CDF-2 inputs chip_smoke.py writes without h5py give the port
    the same results, bit for bit, as the NetCDF4 inputs."""
    d, mesh, cfg, hist, diag, _, got, _, _ = f32_runs
    c = d / "classic"
    c.mkdir()
    attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 60.0,
             "config_lsm_scheme": "noah",
             "config_microp_scheme": "mp_thompson",
             "config_convection_scheme": "cu_ntiedke"}
    write_grid_file_classic(mesh, str(c / "grid.nc"))
    write_data_file_classic(mesh, str(c / "diag.nc"), diag,
                            attrs={**attrs, "output_interval": 15},
                            xtime="2024-03-25_10:00:00", dtype="f8")
    write_data_file_classic(mesh, str(c / "hist.nc"), hist, attrs=attrs,
                            xtime="2024-03-25_10:00:00", dtype="f8")
    for n in ("grid", "diag", "hist"):
        with open(c / f"{n}.nc", "rb") as f:
            assert f.read(4) == b"CDF\x02"
    ccfg = dataclasses.replace(
        cfg, grid_file_input_grid=str(c / "grid.nc"),
        diag_file_input_grid=str(c / "diag.nc"),
        hist_file_input_grid=str(c / "hist.nc"),
        output_file=str(c / "out.nc"))
    art = tpipe.run_pipeline(_port(ccfg), device="cpu")
    a, b = _arrays(art.result), _arrays(got.result)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open_dataset(ccfg.output_file) as f1, \
            open_dataset(cfg.output_file) as f2:
        assert f1.var_names() == f2.var_names()
        assert f1.get_attr("START_DATE") == f2.get_attr("START_DATE")
        assert f1.get_attr("MP_PHYSICS") == f2.get_attr("MP_PHYSICS")


def test_no_pack_rotates_post_hoc(tmp_path, monkeypatch, f32_runs):
    """MPASSIT_NO_PACK=1 runs per-method batches and rotates the mass winds
    after the apply: same results as the packed in-kernel rotation."""
    *_, got, _, _ = f32_runs
    mesh, cfg, _, _ = make_case(tmp_path)
    monkeypatch.setenv("MPASSIT_NO_PACK", "1")
    art = tpipe.run_pipeline(_port(cfg), device="cpu")
    a, b = _arrays(art.result), _arrays(got.result)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_interp_as_bundle_false_and_dump(tmp_path, monkeypatch, f32_runs):
    *_, got, _, _ = f32_runs
    mesh, cfg, _, _ = make_case(tmp_path)
    cfg.interp_as_bundle = False
    dump = tmp_path / "dump.npz"
    monkeypatch.setenv("MPASSIT_DUMP_RESULT", str(dump))
    art = tpipe.run_pipeline(_port(cfg), device="cpu")
    assert [n for n, *_ in art.result.cons2d] == \
        [n for n, *_ in got.result.cons2d]
    for (_, a, *_), (_, b, *_) in zip(art.result.cons2d, got.result.cons2d):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    with np.load(dump) as z:
        np.testing.assert_array_equal(z["u"], art.result.u)
        assert "nz3d.T" in z.files


def test_strip_router_streams_like_in_memory(f32_runs):
    """_ApplyBatch.run with a writer: streamed strips land in the writer
    exactly as the in-memory apply returns them."""
    _, mesh, _, _, _, _, got, _, _ = f32_runs
    rg = got.regridders["bilinear"]
    rng = np.random.default_rng(0)
    a = rng.standard_normal((mesh.ncells, 3)).astype(np.float32)
    b = rng.standard_normal(mesh.ncells).astype(np.float32)
    ref = rg.apply_np(np.concatenate([a, b[:, None]], axis=1))

    class Writer:
        def __init__(self):
            self.puts = {}

        def put(self, var, lev0, block):
            self.puts.setdefault(var, {})[lev0] = np.array(block)

    w, sunk = Writer(), {}
    batch = tpipe._ApplyBatch(rg, np.float32)
    batch.add([a], None, stream=[("A", 3)])
    batch.add(b, lambda arr: sunk.__setitem__("b", arr))
    batch.run(writer=w)
    np.testing.assert_array_equal(w.puts["A"][0], ref[:, :, :3])
    np.testing.assert_array_equal(sunk["b"], ref[:, :, 3])


@pytest.mark.parametrize("override,env", [
    # a mesh of one: bit for bit the unsharded run
    ({"n_device_shards": -1}, None),
    # more shards than ranks: the JAX package's error
    ({"n_device_shards": 2}, None),
    # the ring engine on a mesh of one, against the JAX package's ring
    ({"source_decomp": "ring", "n_device_shards": -1}, None),
    # no mesh: source_decomp changes nothing, as in the JAX package
    ({"source_decomp": "allgather"}, None),
])
def test_unported_options_raise(tmp_path, monkeypatch, override, env,
                                f32_runs):
    """The sharding options run and match the JAX package: each case holds
    the port to the JAX package on the same namelist, where it runs it,
    or to the JAX package's error. (The name is kept from when the port
    refused these options, so that the test's record stays one.)"""
    from mpassit_tpu_torch.parallel.sharding import SourceShardedRegridder

    *_, default, _, _ = f32_runs
    mesh, cfg, _, _ = make_case(tmp_path, cfg_overrides=override)
    if env:
        monkeypatch.setenv(*env)
    if cfg.n_device_shards == 2:
        with pytest.raises(ValueError, match="only 1 devices present"):
            tpipe.run_pipeline(_port(cfg), device="cpu")
        return
    ref = jax_run(cfg, jnp.float32)
    cfg.output_file = str(tmp_path / "out_torch.nc")
    got = tpipe.run_pipeline(_port(cfg), device="cpu")
    _assert_results_close(got.result, ref.result)
    ring = cfg.source_decomp == "ring"
    assert all(isinstance(r, SourceShardedRegridder) == ring
               for r in got.regridders.values())
    if not ring:
        a, b = _arrays(got.result), _arrays(default.result)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_multiprocess_env_raises(monkeypatch):
    """The multi-process variables start a process group: one rank over
    gloo for a CPU device, whose mesh spans it; a second call changes
    nothing; shutdown ends it. (The name is kept from when the port
    refused a multi-process launch, so that the test's record stays
    one.)"""
    import socket

    import torch.distributed as dist

    from mpassit_tpu_torch.parallel import multihost
    from mpassit_tpu_torch.parallel.sharding import make_grid_mesh

    assert multihost.maybe_init_distributed("cpu") is False
    assert not dist.is_initialized()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("MPASSIT_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("MPASSIT_NUM_PROCESSES", "1")
    monkeypatch.setenv("MPASSIT_PROCESS_ID", "0")
    try:
        assert multihost.maybe_init_distributed("cpu") is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert multihost.maybe_init_distributed("cpu") is True
        assert multihost.is_primary()
        m = make_grid_mesh("cpu")
        assert (m.rank, m.world) == (0, 1) and m.group is not None
    finally:
        multihost.shutdown_distributed()
    assert not dist.is_initialized()


def _write_namelist(cfg, path):
    keys = ("grid_file_input_grid", "diag_file_input_grid",
            "hist_file_input_grid", "output_file", "varlist_dir",
            "target_grid_type")
    lines = ["&config"] + [f' {k} = "{getattr(cfg, k)}"' for k in keys]
    lines += [f" {k} = {v}" for k, v in (
        ("interp_diag", ".true."), ("interp_hist", ".true."),
        ("wrf_mod_vars", ".true."), ("nx", cfg.nx), ("ny", cfg.ny),
        ("dx", cfg.dx), ("dy", cfg.dy), ("ref_lat", cfg.ref_lat),
        ("ref_lon", cfg.ref_lon), ("truelat1", cfg.truelat1),
        ("stand_lon", cfg.stand_lon))]
    path.write_text("\n".join(lines + ["/", ""]))


def test_cli_cpu_platform_and_exit_codes(tmp_path, monkeypatch):
    mesh, cfg, _, _ = make_case(tmp_path)
    nml = tmp_path / "namelist.input"
    _write_namelist(cfg, nml)
    monkeypatch.setenv("MPASSIT_PLATFORM", "cpu")
    assert tpipe.main([str(nml)]) == 0
    with open_dataset(cfg.output_file) as f:
        assert f.has_var("U") and f.has_var("T2")
    # missing namelist: FatalError banner, mpi_abort-style exit code
    assert tpipe.main([str(tmp_path / "nope.input")]) == 231
    monkeypatch.setenv("MPASSIT_PLATFORM", "tpu")
    assert tpipe.main([str(nml)]) == 231


def test_cuda_platform_without_gpu_is_an_error(tmp_path, monkeypatch,
                                               capsys):
    """MPASSIT_PLATFORM=cuda (the default) on a machine without a CUDA
    device fails; it never moves the run to the CPU."""
    mesh, cfg, _, _ = make_case(tmp_path)
    nml = tmp_path / "namelist.input"
    _write_namelist(cfg, nml)
    monkeypatch.delenv("MPASSIT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tpipe.main([str(nml)]) == 231
    assert "NO CUDA DEVICE" in capsys.readouterr().err
    assert not os.path.exists(cfg.output_file)


@pytest.mark.parametrize("switch", ["MPASSIT_ELL_KERNEL=0",
                                    "MPASSIT_GATHER_KERNEL=1"])
def test_cuda_platform_without_gpu_is_an_error_on_every_route(
        tmp_path, monkeypatch, capsys, switch):
    """The route switches pick kernels, never a device: without a CUDA
    device the default platform still fails on either route."""
    mesh, cfg, _, _ = make_case(tmp_path)
    nml = tmp_path / "namelist.input"
    _write_namelist(cfg, nml)
    monkeypatch.delenv("MPASSIT_PLATFORM", raising=False)
    monkeypatch.setenv(*switch.split("="))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tpipe.main([str(nml)]) == 231
    assert "NO CUDA DEVICE" in capsys.readouterr().err
    assert not os.path.exists(cfg.output_file)


def test_module_cli_entry(tmp_path):
    """python -m mpassit_tpu_torch: exit code 231 for a missing namelist."""
    env = dict(os.environ, MPASSIT_PLATFORM="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "mpassit_tpu_torch",
         str(tmp_path / "missing.input")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 231
    assert "does not exist" in proc.stderr
