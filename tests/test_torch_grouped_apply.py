"""The column-grouped, device-memory-bounded packed apply of
mpassit_tpu_torch.ops.matmul_apply (``PackedSlabRegridder._grouped_width``
and ``apply_np``, ``_src_window_to_device``, ``device_budget``,
``_fetch_strips``) on the shapes of tests/test_matmul_apply.py's grouped test (cols 500/80/60, so
Cp = 640 > FETCH):

- grouped equals full-width bit for bit on the default route, for every
  source form (one array, a block list, strips to a sink), with and
  without the in-kernel rotation; on the one-hot route too, since the
  plain version's per-column products do not depend on the column window
  (each method's bmm takes the group's columns of the same slab rows);
- the port's grouped result against the JAX package's grouped apply_np
  (backend="xla"), rtol 2e-6, atol 2e-5 (the R10 'highest' class, as
  tests/test_torch_apply.py);
- the two faults of the JAX copy the port does not have: a group width
  that is not a multiple of LANE (the JAX package returns 300 for a
  rotation window ending at column 300; the port 384), and a window
  upload that converts the whole block before slicing it; and what the JAX
  package's rule leaves out of the budget (the operands, the fetch's
  device copy), which the port counts."""

import numpy as np
import pytest
import torch

from mpassit_tpu.mesh.reorder import reorder_cells_morton
from mpassit_tpu.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_tpu.ops import matmul_apply as jm
from mpassit_tpu.weights.bilinear import bilinear_cell_weights
from mpassit_tpu.weights.conservative import conservative_weights
from mpassit_tpu.weights.nearest import nearest_weights
from mpassit_tpu_torch.ops import gather_kernel as gk
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.ops import onehot_kernel as ok
from mpassit_tpu_torch.ops import packed_kernel as pk

from test_weights import coarse_lambert_grid

CPU = torch.device("cpu")
TOL = dict(rtol=2e-6, atol=2e-5)
COLS = [500, 80, 60]
TINY = "0.001"          # GB: every pack here exceeds it


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_budget(monkeypatch):
    monkeypatch.delenv("MPASSIT_DEVICE_BUDGET_GB", raising=False)


@pytest.fixture(scope="module")
def problem():
    mesh = synthetic_voronoi_mesh(ncells=3000, nz=3, nsoil=1, seed=9)
    grid = coarse_lambert_grid(nx=64, ny=40, dx=80e3)
    mesh = reorder_cells_morton(mesh, grid.proj).mesh
    ells = (bilinear_cell_weights(mesh, grid.lat, grid.lon),
            nearest_weights(mesh, grid.lat, grid.lon),
            conservative_weights(mesh, grid))
    src = np.random.default_rng(21).standard_normal(
        (mesh.ncells, sum(COLS))).astype(np.float32)
    return ells, src


def _spec(ells, window):
    """rotate_spec for ``window`` (None: no rotation)."""
    if window is None:
        return {}
    ny, nx = ells[0].dst_shape
    alpha = np.random.default_rng(3).uniform(-0.3, 0.3, (ny, nx))
    return {"rotate_spec": ((window,), np.cos(alpha).astype(np.float32),
                            np.sin(alpha).astype(np.float32))}


def _apply(rg, src, form):
    """apply_np of ``src`` as one array, as a block list, or through a
    strip sink, reassembled."""
    if form == "array":
        return rg.apply_np(src)
    blocks = [src[:, :17], src[:, 17:300], src[:, 300:]]
    if form == "blocks":
        return rg.apply_np(blocks)
    strips = {}
    assert rg.apply_np(blocks, strip_sink=lambda lo, s: strips.__setitem__(
        lo, np.array(s))) is None
    assert all(s.shape[2] <= tm.CB for s in strips.values())
    return np.concatenate([strips[k] for k in sorted(strips)], axis=2)


@pytest.mark.parametrize("form", ["array", "blocks", "sink"])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("route", ["ell", "onehot"])
def test_grouped_equals_full(problem, monkeypatch, route, rotate, form):
    ells, src = problem
    if route == "onehot":
        monkeypatch.setenv("MPASSIT_ELL_KERNEL", "0")
    rg = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU,
                                precision="split6_bf16",
                                **_spec(ells, (0, 2, 2) if rotate else None))
    assert rg.route == route and rg.Cp == 640 > tm.FETCH
    assert rg._grouped_width() == 0          # the CPU default, 12 GB
    full = rg.apply_np(src)
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", TINY)
    gw = rg._grouped_width()
    # halved to LANE; the rotation keeps CB columns in group 0
    assert gw == (tm.CB if rotate else tm.LANE)
    p0, o0 = pk.PLAIN_CALLS, dict(ok.PLAIN_CALLS)
    got = _apply(rg, src, form)
    n_groups = -(-rg.Cp // gw)
    if route == "ell":
        assert pk.PLAIN_CALLS == p0 + n_groups and ok.PLAIN_CALLS == o0
    else:
        assert pk.PLAIN_CALLS == p0
        assert (ok.PLAIN_CALLS["onehot_apply_packed"]
                == o0["onehot_apply_packed"] + n_groups)
    np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("rotate", [False, True])
def test_grouped_matches_jax_grouped(problem, monkeypatch, rotate):
    ells, src = problem
    kw = _spec(ells, (0, 2, 2) if rotate else None)
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", TINY)
    jr = jm.PackedSlabRegridder(list(zip(ells, COLS)), backend="xla", **kw)
    rg = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU, **kw)
    assert jr._grouped_width() == rg._grouped_width() > 0
    np.testing.assert_allclose(rg.apply_np(src), jr.apply_np(src), **TOL)


def test_group_width_is_a_lane_multiple(problem, monkeypatch):
    """A rotation window ending at column 300: the JAX package's group
    width is 300, which no 128-column kernel block divides; the port's is
    384, and its grouped result is still the full-width one."""
    ells, src = problem
    kw = _spec(ells, (256, 278, 22))
    full = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU,
                                  **kw).apply_np(src)
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", TINY)
    assert jm.PackedSlabRegridder(list(zip(ells, COLS)), backend="xla",
                                  **kw)._grouped_width() == 300
    rg = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU, **kw)
    assert rg._grouped_width() == 384
    np.testing.assert_array_equal(rg.apply_np(src), full)


def test_gather_route_is_never_grouped(problem, monkeypatch):
    ells, src = problem
    monkeypatch.setenv("MPASSIT_GATHER_KERNEL", "1")
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", TINY)
    rg = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU)
    assert rg.route == "gather" and rg._grouped_width() > 0
    g0, p0 = gk.PLAIN_CALLS, pk.PLAIN_CALLS
    rg.apply_np(src)
    assert gk.PLAIN_CALLS == g0 + 1 and pk.PLAIN_CALLS == p0


class _CountedBlock:
    """An f64 column block that counts its whole-block conversions to
    another dtype (numpy calls ``__array__`` with it); slicing it returns
    a plain view."""

    def __init__(self, a):
        self.a, self.converted = a, 0
        self.shape, self.ndim = a.shape, a.ndim

    def __getitem__(self, key):
        return self.a[key]

    def __array__(self, dtype=None, copy=None):
        if dtype is None or dtype == self.a.dtype:
            return self.a
        self.converted += 1
        return self.a.astype(dtype)


def test_window_upload_converts_only_the_window(problem, monkeypatch):
    """Each group converts only its own columns of an f64 block; the JAX
    package's copy converts the whole block once per group it meets."""
    ells, src = problem
    ref = src.astype(np.float64)
    blk = _CountedBlock(ref)
    win = tm._src_window_to_device([blk], 128, 256, CPU)
    assert blk.converted == 0
    np.testing.assert_array_equal(win.numpy(),
                                  ref[:, 128:384].astype(np.float32))
    jm._src_window_to_device([blk], 128, 256)
    assert blk.converted == 1
    # past the data: zero columns
    tail = tm._src_window_to_device([src[:, :600], src[:, 600]], 512, 128,
                                    CPU).numpy()
    np.testing.assert_array_equal(tail[:, :89], src[:, 512:601])
    assert not tail[:, 89:].any()
    # a whole grouped apply of counted blocks: no whole-block conversion
    full = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU).apply_np(src)
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", TINY)
    blocks = [_CountedBlock(ref[:, :300]), _CountedBlock(ref[:, 300:])]
    rg = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU)
    np.testing.assert_array_equal(rg.apply_np(blocks), full)
    assert [b.converted for b in blocks] == [0, 0]


def test_device_budget(monkeypatch):
    """The environment variable when set; else, on a CUDA device, the
    operands' bytes plus FREE_SHARE of its free bytes and of the caching
    allocator's reserved but unallocated bytes at the call; else the JAX
    package's 12 GB."""
    assert tm.device_budget(CPU) == 12e9
    calls = []

    def mem_get_info(dev):
        calls.append(dev)
        return 5e9, 80e9
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 3e9)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 2e9)
    cuda = torch.device("cuda", 0)
    assert tm.device_budget(cuda, held=1e9) == pytest.approx(
        1e9 + tm.FREE_SHARE * 6e9)
    assert calls == [cuda]
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", "4")
    assert tm.device_budget(cuda, 1e9) == tm.device_budget(CPU) == 4e9
    assert len(calls) == 1


def test_group_width_counts_operands_and_fetch_chunk(problem, monkeypatch):
    """A budget that one pass's source, slab and output columns fit, but
    not with the operands and a fetch chunk beside them: the port groups,
    the JAX package's rule (which counts the columns alone) does not."""
    ells, src = problem
    rg = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU)
    per_col = 4 * (rg.n_src + rg.n_tiles * rg.W
                   + rg.nty * tm.TY * rg.ntx * tm.TX)
    need = rg.Cp * per_col + rg._held_bytes() + tm.FETCH_TMP
    assert rg._held_bytes() > 0
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", repr((need + 1e3) / 1e9))
    assert rg._grouped_width() == 0
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", repr((need - 1e3) / 1e9))
    assert rg._grouped_width() == tm.FETCH // 2       # 640 columns: 2 groups
    assert jm.PackedSlabRegridder(list(zip(ells, COLS)),
                                  backend="xla")._grouped_width() == 0


@pytest.mark.parametrize("sink", [False, True])
def test_fetch_in_row_chunks(problem, monkeypatch, sink):
    """A staged chunk (FETCH_TMP // FETCH_CHUNKS) of three rows of a CB
    strip: every strip crosses in several row chunks (the sink's CB strips
    three rows at a time, the last chunk short), into the output or to the
    sink, and the result is the one-chunk fetch's."""
    ells, src = problem
    rg = tm.PackedSlabRegridder(list(zip(ells, COLS)), CPU)
    full = rg.apply_np(src)
    ny, nx = rg.dst_shape
    monkeypatch.setattr(tm, "FETCH_TMP", tm.FETCH_CHUNKS * 3 * 4 * nx * tm.CB)
    assert ny % 3
    got = _apply(rg, src, "sink" if sink else "array")
    np.testing.assert_array_equal(got, full)
