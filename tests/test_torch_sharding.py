"""The port's sharded applies (mpassit_tpu_torch/parallel/sharding.py and
the tile-row-sharded engines of ops/matmul_apply.py) over gloo ranks,
mirroring tests/test_sharding.py. torch has no virtual multi-device CPU
mesh, so each world size is one torch.multiprocessing spawn of CPU ranks
(mpassit_tpu_torch.tools.dryrun_multichip.run, time-limited, the ranks
killed past it), at 2 and 3 ranks, on a 150 x 40 Lambert grid: 5 tile
rows, a multiple of neither. Checked against the unsharded engines run in
this process and the JAX package's:

- ShardedRegridder (f64, replicated source) bit for bit the port's
  unsharded Regridder, and within 1e-13 (rtol and atol) of the JAX
  package's Regridder, for every operator;
- SourceShardedRegridder ring and allgather, ring_apply and
  shard_map_apply (2-D and 1-D sources) within 1e-13 in f64;
- the tile-row-sharded slab and packed applies (the packed one with the
  Q4 rotation in the kernel, also on the one-hot route) bit for bit the
  1-rank result, in one pass and grouped, into a strip sink, root-only
  (zeros off rank 0);
- every rank's gather-to-all result equal to rank 0's; the dry-run tool's
  CLI at 2 ranks; the band, mesh and fetch rules without a spawn."""

import json
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.ops.apply import Regridder as JaxRegridder
from mpassit_tpu.weights.ell import ELLWeights as JaxELL
from mpassit_tpu_torch.errors import FatalError
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.parallel.sharding import GridMesh, band_rows
from mpassit_tpu_torch.run import pipeline as tpipe
from mpassit_tpu_torch.tools import dryrun_multichip as dm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("bilinear", "nearest", "conserve", "vertex", "edge1")
WORLDS = (2, 3)
TOL = dict(rtol=dm.TOL_F64, atol=dm.TOL_F64)


@pytest.fixture(scope="module")
def problem():
    prob = dm.build_problem(3000, 40, 150)
    assert -(-150 // tm.TY) == 5
    return prob


@pytest.fixture(scope="module")
def runs(problem):
    """{world: (summary, {rank: results}, unsharded results)}."""
    return {w: dm.run(w, problem, platform="cpu", timeout=240)
            for w in WORLDS}


@pytest.mark.parametrize("method", METHODS)
def test_replicate_f64_bit_for_bit_and_jax(runs, problem, method):
    e = problem["ells"][method]
    src = problem["src"][method][:, :dm.NCOL]
    jax_ref = JaxRegridder(JaxELL(e.idx, e.w, e.n_src, method, e.dst_shape),
                           dtype=jnp.float64).apply_np(src)
    for w in WORLDS:
        _, ranks, ref = runs[w]
        got = ranks[0][f"replicate.{method}"]
        np.testing.assert_array_equal(got, ref[f"replicate.{method}"])
        np.testing.assert_allclose(got, np.asarray(jax_ref), **TOL)


@pytest.mark.parametrize("comm", ["ring", "allgather"])
@pytest.mark.parametrize("method", METHODS)
def test_source_sharded_f64(runs, method, comm):
    for w in WORLDS:
        _, ranks, ref = runs[w]
        got, want = ranks[0][f"{comm}.{method}"], ref[f"{comm}.{method}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fn", ["ring_apply", "shard_map_apply"])
@pytest.mark.parametrize("tag", ["", "_1d"])
def test_ring_and_shard_map_apply(runs, problem, fn, tag):
    n_dst = problem["ells"]["bilinear"].n_dst
    for w in WORLDS:
        _, ranks, ref = runs[w]
        got = ranks[0][fn + tag]
        assert got.shape == ((n_dst,) if tag else (n_dst, dm.NCOL))
        np.testing.assert_allclose(got, ref[fn + tag], **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["slab.bilinear", "slab.vertex",
                                 "slab.edge1", "packed", "packed_onehot"])
def test_tile_row_sharded_bit_for_bit(runs, world, key):
    _, ranks, ref = runs[world]
    assert ranks[0][key].dtype == np.float32
    np.testing.assert_array_equal(ranks[0][key], ref[key])


@pytest.mark.parametrize("world", WORLDS)
def test_grouped_sharded(runs, world):
    """MPASSIT_DEVICE_BUDGET_GB tiny: the same groups on every rank (the
    rotation's CB floor), bit for bit the 1-rank full-width pass, into
    the host array and into a strip sink."""
    _, ranks, ref = runs[world]
    for r in ranks.values():
        assert int(r["packed_group_width"]) == tm.CB
    for key in ("packed_grouped", "packed_grouped_sink"):
        np.testing.assert_array_equal(ranks[0][key], ref["packed"])


@pytest.mark.parametrize("world", WORLDS)
def test_root_only_and_gather_to_all(runs, world):
    summary, ranks, ref = runs[world]
    np.testing.assert_array_equal(ranks[0]["packed_root_only"],
                                  ref["packed"])
    for r in range(1, world):
        assert ranks[r]["packed_root_only"].shape == ref["packed"].shape
        assert not ranks[r]["packed_root_only"].any()
        for k in ranks[0]:
            if k != "packed_root_only":
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                              err_msg=k)
    assert summary["ok"] and not summary["failed"], summary


def test_dryrun_tool_two_ranks(tmp_path):
    """The tool's CLI at N=2 on the CPU: one summary line, every check
    passed, exit 0; its process session is killed past 300 s."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpassit_tpu_torch.tools.dryrun_multichip",
         "--ranks", "2", "--platform", "cpu", "--ncells", "1200", "--nx",
         "24", "--ny", "40"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["ok"] and summary["ranks"] == 2
    assert summary["backend"] == "gloo" and summary["failed"] == []
    assert summary["n_checks"] >= 25


def test_band_rows_pads_every_rank():
    a = np.arange(10).reshape(5, 2) + 1
    bands = [band_rows(a, GridMesh(r, 4, torch.device("cpu")))
             for r in range(4)]
    assert [b.shape[0] for b in bands] == [2, 2, 2, 2]
    np.testing.assert_array_equal(np.concatenate(bands)[:5], a)
    assert not bands[2][1:].any() and not bands[3].any()
    b = band_rows(a, GridMesh(1, 2, torch.device("cpu")), n=4)
    np.testing.assert_array_equal(b, np.concatenate([a[4:], np.zeros(
        (3, 2), a.dtype)]))


def test_device_mesh_rules(tmp_path, monkeypatch):
    """0/1 no mesh; -1 a mesh of one without a process group; more shards
    than ranks the JAX package's ValueError; fewer than the ranks (but
    more than one) refused."""
    from mpassit_tpu_torch.config import Config

    cfg = Config()
    for n in (0, 1):
        cfg.n_device_shards = n
        assert tpipe._device_mesh(cfg, "cpu") is None
    cfg.n_device_shards = -1
    assert tpipe._device_mesh(cfg, "cpu") == GridMesh(
        0, 1, torch.device("cpu"))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    cfg.n_device_shards = 5
    with pytest.raises(ValueError, match="only 4 devices present"):
        tpipe._device_mesh(cfg, "cpu")
    cfg.n_device_shards = 2
    with pytest.raises(FatalError, match="ONE DEVICE PER RANK"):
        tpipe._device_mesh(cfg, "cpu")


def test_fetch_counts_the_gathered_chunks():
    """The budget's fetch term: the two chunks in flight without a process
    group; under one each chunk also holds this rank's own part, made
    contiguous for the gather. A chunk is one row of every rank where
    that is more than FETCH_CHUNK."""
    cpu = torch.device("cpu")
    group = GridMesh(1, 4, cpu, object())
    assert tm._fetch_bytes(None) == 2 * tm.FETCH_CHUNK
    assert tm._fetch_bytes(GridMesh(0, 1, cpu)) == 2 * tm.FETCH_CHUNK
    assert tm._fetch_bytes(group) == \
        2 * (tm.FETCH_CHUNK + tm.FETCH_CHUNK // 4)
    assert tm._fetch_bytes(None, tm.FETCH_CHUNK) == 2 * tm.FETCH_CHUNK
    assert tm._fetch_bytes(None, tm.FETCH_CHUNK + 4) == \
        2 * (tm.FETCH_CHUNK + 4)
    row = tm.FETCH_CHUNK // 2                  # 4 ranks: a 2-chunk row
    assert tm._fetch_bytes(group, row) == 2 * (4 * row + row)


def test_gather_route_is_off_under_a_mesh(problem, monkeypatch):
    monkeypatch.setenv("MPASSIT_GATHER_KERNEL", "1")
    e = problem["ells"]["bilinear"]
    cpu = torch.device("cpu")
    assert tm.PackedSlabRegridder([e], cpu).route == "gather"
    rg = tm.PackedSlabRegridder([e], cpu, mesh=GridMesh(1, 2, cpu))
    assert rg.route == "ell"
    assert (rg.nty, rg.nty_l, rg.nty_p, rg.n_tiles) == (5, 3, 6, 3 * rg.ntx)


_LAUNCH_VARS = ("MPASSIT_COORDINATOR", "MPASSIT_NUM_PROCESSES",
                "MPASSIT_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.mark.parametrize("env,match", [
    ({"MPASSIT_COORDINATOR": "localhost:1"},
     "MPASSIT_NUM_PROCESSES IS NOT SET"),
    ({"MPASSIT_COORDINATOR": "localhost:1", "MPASSIT_NUM_PROCESSES": "2"},
     "MPASSIT_PROCESS_ID IS NOT SET"),
    ({"MPASSIT_COORDINATOR": "localhost:1", "MPASSIT_NUM_PROCESSES": "2",
      "MPASSIT_PROCESS_ID": "2"},
     r"MPASSIT_PROCESS_ID='2': EXPECTED AN INTEGER \[0, 2\)"),
    ({"MPASSIT_COORDINATOR": "localhost:1", "MPASSIT_NUM_PROCESSES": "0",
      "MPASSIT_PROCESS_ID": "0"},
     "MPASSIT_NUM_PROCESSES='0': EXPECTED AN INTEGER >= 1"),
    ({"MPASSIT_NUM_PROCESSES": "2"}, "MASTER_ADDR IS NOT SET"),
    ({"MPASSIT_NUM_PROCESSES": "2", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "1", "WORLD_SIZE": "3", "RANK": "0"},
     "WORLD_SIZE=3 BUT MPASSIT_NUM_PROCESSES=2"),
], ids=["no_world", "no_rank", "rank_out_of_range", "world_zero",
        "env_no_master", "env_world_differs"])
def test_launch_variables_checked(monkeypatch, env, match):
    """A multi-process launch with a variable missing or out of range is a
    FatalError naming it, raised before any rendezvous: no process takes
    rank 0 by default and waits at the rendezvous for the timeout."""
    from mpassit_tpu_torch.parallel import multihost

    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(FatalError, match=match):
        multihost.maybe_init_distributed("cpu")
    assert not torch.distributed.is_initialized()


def test_launch_spec_of_a_checked_launch(monkeypatch):
    from mpassit_tpu_torch.parallel import multihost

    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MPASSIT_COORDINATOR", "localhost:7")
    monkeypatch.setenv("MPASSIT_NUM_PROCESSES", "4")
    monkeypatch.setenv("MPASSIT_PROCESS_ID", "3")
    assert multihost.launch_spec() == (4, 3, "tcp://localhost:7")
    monkeypatch.delenv("MPASSIT_COORDINATOR")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "7")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "1")
    assert multihost.launch_spec() == (4, 1, "env://")


def test_cli_launch_without_rank_is_fatal(tmp_path, monkeypatch, capsys):
    """The CLI with a coordinator and no process id: the FatalError banner
    and the abort's exit code, no output file."""
    from test_torch_pipeline import _write_namelist
    from test_pipeline import make_case

    _, cfg, _, _ = make_case(tmp_path)
    nml = tmp_path / "namelist.input"
    _write_namelist(cfg, nml)
    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MPASSIT_PLATFORM", "cpu")
    monkeypatch.setenv("MPASSIT_COORDINATOR", "localhost:1")
    monkeypatch.setenv("MPASSIT_NUM_PROCESSES", "2")
    assert tpipe.main([str(nml)]) == 231
    assert "MPASSIT_PROCESS_ID IS NOT SET" in capsys.readouterr().err
    assert not os.path.exists(cfg.output_file)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("platform", [None, "cuda"])
def test_dryrun_defaults_to_the_card(monkeypatch, capsys, platform):
    """The dry run's ranks run on the cards unless the caller asks for the
    CPU (MPASSIT_PLATFORM, then --platform); without enough cards it
    fails and never moves to the CPU."""
    monkeypatch.delenv("MPASSIT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    argv = ["--ranks", "2"] + (["--platform", platform] if platform else [])
    assert dm.main(argv) == 1
    assert "2 ranks need as many CUDA devices" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="0 present"):
        dm.run(2, {}, timeout=1)
    monkeypatch.setenv("MPASSIT_PLATFORM", "cpu")
    dm.check_platform("cpu", 2)
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        dm.check_platform("tpu", 2)
