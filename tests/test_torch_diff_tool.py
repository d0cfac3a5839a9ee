"""mpassit_tpu_torch/tools/diff_against_reference.py, the port's parity
check against a real MPASSIT output, run with h5py blocked from import (it
reads through the port's HDF5 reader, as on a machine without h5py): the
counterparts of tests/test_diff_tool.py's four tests on a file the port
wrote, and the JAX package's tool giving the same report, JSON and exit
code on the same pair of files, also where the reference was written by
netCDF-C (superblock 2, deflated, as the Fortran MPASSIT writes it)."""

import json
import os
import shutil
import subprocess
import sys

import h5py
import pytest

from mpassit_tpu_torch.run import pipeline as tpipe

import nc4_foreign as nf
from test_pipeline import make_case
from test_torch_pipeline import REPO, _port

#: the port's tool in a process where h5py cannot be imported
PORT_TOOL = ("import sys; sys.modules['h5py'] = None; "
             "from mpassit_tpu_torch.tools.diff_against_reference import "
             "main; sys.exit(main())")


@pytest.fixture(scope="module")
def out_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("difftool_torch")
    _, cfg, _, _ = make_case(d)
    cfg = _port(cfg)
    tpipe.run_pipeline(cfg, device="cpu")
    return cfg.output_file


def _run(*args, tool=PORT_TOOL):
    cmd = ([sys.executable, "-c", tool] if tool == PORT_TOOL
           else [sys.executable, tool])
    return subprocess.run(cmd + list(args), capture_output=True, text=True,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          timeout=300)


def _edit(src, dst, *edits):
    """A copy of ``src`` with each (var, index, f) edit: a[index] = f(it)."""
    shutil.copy(src, dst)
    with h5py.File(dst, "r+") as f:
        for var, index, fn in edits:
            a = f[var][...]
            a[index] = fn(a[index])
            f[var][...] = a
    return dst


def test_self_compare_exits_zero(out_file):
    r = _run(out_file, out_file)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FAIL" not in r.stdout
    assert "match:" in r.stdout


def test_perturbed_var_fails(out_file, tmp_path):
    bad = _edit(out_file, str(tmp_path / "bad.nc"),
                ("T", (0, 0, 3, 4), lambda x: x + 1.0))
    r = _run(out_file, bad)
    assert r.returncode == 1
    assert "FAIL       T:" in r.stdout


def test_known_deviation_reported_not_failed(out_file, tmp_path):
    dev = _edit(out_file, str(tmp_path / "dev.nc"),
                ("U", (0, 0, 0, 0), lambda x: x + 0.5))
    r = _run(out_file, dev)
    assert r.returncode == 0, r.stdout
    assert "DEVIATION  U:" in r.stdout
    assert "register row R3" in r.stdout


def test_mask_unmapped(out_file, tmp_path):
    z = _edit(out_file, str(tmp_path / "zeroed.nc"),
              ("T", (0, 0, 1, 1), lambda x: 0.0))
    r = _run(out_file, z, "--mask-unmapped")
    assert r.returncode == 0, r.stdout
    assert "unmapped-suspect" in r.stdout

    r2 = _run(out_file, z)
    assert r2.returncode == 1


@pytest.mark.parametrize("flags", [[], ["--mask-unmapped", "--rtol", "1e-3",
                                        "--skip", "Times", "T2"]])
def test_same_report_as_the_jax_tool(out_file, tmp_path, flags):
    """Failures, a deviation and unmapped-suspect points: the same
    stdout, JSON report and exit code from both tools."""
    bad = _edit(out_file, str(tmp_path / "bad.nc"),
                ("T", (0, 0, 3, 4), lambda x: x + 1.0),
                ("T", (0, 0, 1, 1), lambda x: 0.0),
                ("U", (0, 0, 0, 0), lambda x: x + 0.5),
                ("T2", (0, 1, 1), lambda x: 0.0))
    got = _run(out_file, bad, "--json", str(tmp_path / "port.json"), *flags)
    want = _run(out_file, bad, "--json", str(tmp_path / "jax.json"), *flags,
                tool=os.path.join("tools", "diff_against_reference.py"))
    assert want.returncode in (0, 1), want.stderr
    assert got.returncode == want.returncode, got.stderr
    assert got.stdout == want.stdout
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


@pytest.mark.skipif(nf.libnetcdf() is None,
                    reason="system libnetcdf not present")
@pytest.mark.parametrize("flags", [[], ["--mask-unmapped", "--rtol", "1e-3",
                                        "--skip", "Times", "T2"]])
def test_netcdf_c_reference_same_report_as_the_jax_tool(out_file, tmp_path,
                                                        flags):
    """The reference file written by netCDF-C (superblock 2, every
    variable deflated and shuffled, the global attributes dense), read by
    the port's tool with h5py blocked: the same stdout, JSON report and
    exit code as the JAX tool's through h5py on the same pair."""
    ref = str(tmp_path / "reference_ncc.nc")
    nf.copy_through_netcdf_c(out_file, ref)
    with h5py.File(ref, "r") as f:
        assert f["T"].compression == "gzip" and f["T"].shuffle
    with open(ref, "rb") as f:
        assert f.read(9)[8] == 2
    bad = _edit(out_file, str(tmp_path / "bad.nc"),
                ("T", (0, 0, 3, 4), lambda x: x + 1.0),
                ("T", (0, 0, 1, 1), lambda x: 0.0),
                ("U", (0, 0, 0, 0), lambda x: x + 0.5),
                ("T2", (0, 1, 1), lambda x: 0.0))
    same = _run(ref, out_file)
    assert same.returncode == 0, same.stdout + same.stderr
    assert "FAIL" not in same.stdout
    got = _run(ref, bad, "--json", str(tmp_path / "port.json"), *flags)
    want = _run(ref, bad, "--json", str(tmp_path / "jax.json"), *flags,
                tool=os.path.join("tools", "diff_against_reference.py"))
    assert want.returncode in (0, 1), want.stderr
    assert got.returncode == want.returncode, got.stderr
    assert got.stdout == want.stdout
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
