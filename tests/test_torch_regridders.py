"""mpassit_tpu_torch.ops.matmul_apply against mpassit_tpu.ops.matmul_apply:
the host pack byte for byte, and PackedSlabRegridder ``apply_np`` over one
operator and over the union of three (rotation, block-list sources,
strip_sink, root_only) against the JAX package's SlabMatmulRegridder and
PackedSlabRegridder with backend="xla" and backend="pallas" (interpret
mode). Tolerance: rtol 2e-6, atol 2e-5 (the
R10 'highest' class, ~2e-7 max rel err of either arithmetic vs f64).

The routes the switches pick: under MPASSIT_ELL_KERNEL=0 both uses
against the JAX classes under the same switch, for each precision, at
rtol 1e-6 of the largest |ref| (the same terms summed in another order);
under MPASSIT_GATHER_KERNEL=1 bit for bit the port's default route; the
plain-call counters show which kernel's plain version ran."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mpassit_tpu.mesh.reorder import reorder_cells_morton
from mpassit_tpu.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_tpu.ops import matmul_apply as jm
from mpassit_tpu.weights.bilinear import bilinear_cell_weights
from mpassit_tpu.weights.conservative import conservative_weights
from mpassit_tpu.weights.ell import ELLWeights
from mpassit_tpu.weights.nearest import nearest_weights
from mpassit_tpu_torch.ops import gather_kernel as gk
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.ops import onehot_kernel as ok
from mpassit_tpu_torch.ops import packed_kernel as pk
from mpassit_tpu_torch.spans import Timings, recording

from test_weights import coarse_lambert_grid

CPU = torch.device("cpu")
TOL = dict(rtol=2e-6, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    mesh = synthetic_voronoi_mesh(ncells=3000, nz=3, nsoil=1, seed=9)
    grid = coarse_lambert_grid(nx=64, ny=40, dx=80e3)
    mesh = reorder_cells_morton(mesh, grid.proj).mesh
    ells = (bilinear_cell_weights(mesh, grid.lat, grid.lon),
            nearest_weights(mesh, grid.lat, grid.lon),
            conservative_weights(mesh, grid))
    return mesh, grid, ells


def _rotation(ell, seed=3):
    ny, nx = ell.dst_shape
    alpha = np.random.default_rng(seed).uniform(-0.3, 0.3, (ny, nx))
    return np.cos(alpha).astype(np.float32), np.sin(alpha).astype(np.float32)


def _rotated(ells, window, seed=3):
    """The JAX package's rotate_spec for ``window`` (None: no rotation),
    the port's ``rotation`` grid and its call's windows."""
    if window is None:
        return {}, {}, ()
    cosa, sina = _rotation(ells[0], seed)
    return ({"rotate_spec": ((window,), cosa, sina)},
            {"rotation": (cosa, sina)}, (window,))


@pytest.mark.parametrize("seed,shape", [(0, (40, 70, 500, 3)),
                                        (1, (33, 34, 37, 1)),
                                        (2, (64, 32, 3000, 2))])
def test_pack_equals_jax_byte_for_byte(seed, shape):
    ny, nx, n_src, K = shape
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, n_src, (ny * nx, K)), axis=1)
    w = rng.random((ny * nx, K))
    w[rng.random((ny * nx, K)) < 0.15] = 0.0
    got = tm._pack_union(idx, w, ny, nx, n_src)
    ref = jm._pack_union(idx, w, ny, nx, n_src)
    assert len(got) == 7
    for a, b in zip(got, ref[:7]):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        else:
            assert a == b
    assert ref[7:] == (got[6], got[4])      # n_tiles_data, nty_p: no mesh
    gc, rc = tm._pack_compact(got), jm._pack_compact(ref)
    for a, b in zip(gc[:3], rc[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_pack_on_real_weights_and_cache(problem, tmp_path):
    """The union pack of the three methods equals the JAX package's; the
    port's cache entries sit beside the JAX ones without colliding."""
    _, _, ells = problem
    cols = [5, 3, 2]
    jp = jm.PackedSlabRegridder(list(zip(ells, cols)), backend="xla",
                                cache_dir=str(tmp_path))
    tp = tm.PackedSlabRegridder(list(ells), CPU, cache_dir=str(tmp_path))
    assert (tp.W, tp.nty, tp.ntx, tp.n_tiles) == (jp.W, jp.nty, jp.ntx,
                                                  jp.n_tiles)
    np.testing.assert_array_equal(tp.slab_idx.numpy(),
                                  np.asarray(jp.slab_idx).reshape(-1))
    for m in range(3):
        np.testing.assert_array_equal(tp._ell_dev()[0][m].numpy(),
                                      np.asarray(jp._ell_dev()[0][m]))
        np.testing.assert_array_equal(tp._ell_dev()[1][m].numpy(),
                                      np.asarray(jp._ell_dev()[1][m]))
    names = sorted(os.listdir(tmp_path))
    assert any(n.startswith("pack_") for n in names)
    assert any(n.startswith("torchpack_") for n in names)
    again = tm.PackedSlabRegridder(list(ells), CPU, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(again.slab_idx.numpy(),
                                  tp.slab_idx.numpy())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_slab_apply_np_matches_jax(small_mesh, backend):
    ny, nx = 33, 34       # forces tile padding on both axes
    lat = np.linspace(-25, 25, ny)[:, None] + np.zeros((1, nx))
    lon = np.linspace(-40, 40, nx)[None, :] + np.zeros((ny, 1))
    ell = bilinear_cell_weights(small_mesh, lat.ravel(), lon.ravel())
    ell = dataclasses.replace(ell, dst_shape=(ny, nx))
    src = np.random.default_rng(5).standard_normal(
        (small_mesh.ncells, 3)).astype(np.float32)
    ref = jm.SlabMatmulRegridder(ell, backend=backend).apply_np(src)
    rg = tm.PackedSlabRegridder([ell], CPU)
    np.testing.assert_allclose(rg.apply_np(src), ref, **TOL)
    np.testing.assert_allclose(rg.apply_np(src[:, 1]), ref[:, :, 1], **TOL)
    np.testing.assert_array_equal(rg.apply_np(src, root_only=True),
                                  rg.apply_np(src))


@pytest.mark.parametrize("C", [1, 128, 129, 600])
def test_slab_blocks_and_strips(problem, C):
    """Block-list sources and strip streaming give the one-array result,
    across the 128-column pad quantum and past FETCH columns."""
    mesh, _, (ell, _, _) = problem
    src = np.random.default_rng(C).standard_normal(
        (mesh.ncells, C)).astype(np.float32)
    rg = tm.PackedSlabRegridder([ell], CPU)
    full = rg.apply_np(src)
    ref = jm.SlabMatmulRegridder(ell, backend="xla").apply_np(src)
    np.testing.assert_allclose(full, ref, **TOL)
    cuts = sorted({0, C // 3, C // 2, C})
    blocks = [src[:, a:b] for a, b in zip(cuts, cuts[1:]) if b > a]
    np.testing.assert_array_equal(rg.apply_np(blocks), full)
    strips = {}
    assert rg.apply_np(blocks, strip_sink=lambda lo, s: strips.__setitem__(
        lo, np.array(s))) is None
    assert all(s.shape[2] <= tm.CB for s in strips.values())
    got = np.concatenate([strips[k] for k in sorted(strips)], axis=2)
    np.testing.assert_array_equal(got, full)
    # the device-side __call__ returns the tile-padded grid
    dev = rg(torch.from_numpy(src))
    assert dev.shape == (rg.nty * 32, rg.ntx * 32, C)
    np.testing.assert_array_equal(
        dev[:ell.dst_shape[0], :ell.dst_shape[1]].numpy(), full)


def test_one_operator_takes_any_columns_per_call(problem):
    """One operator, built once, applied in turn to 3, 130 and 600 columns
    (one array, then a block list): each call equals the JAX package's
    SlabMatmulRegridder on the same source."""
    mesh, _, (ell, _, _) = problem
    rg = tm.PackedSlabRegridder([ell], CPU)
    jr = jm.SlabMatmulRegridder(ell, backend="xla")
    for C in (3, 130, 600):
        src = np.random.default_rng(C + 1).standard_normal(
            (mesh.ncells, C)).astype(np.float32)
        ref = jr.apply_np(src)
        np.testing.assert_allclose(rg.apply_np(src), ref, **TOL)
        blocks = [src[:, :C // 2], src[:, C // 2:]]
        np.testing.assert_allclose(rg.apply_np(blocks), ref, **TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("rotate", [False, True])
def test_packed_apply_np_matches_jax(problem, backend, rotate):
    mesh, _, ells = problem
    cols = [5, 3, 2]
    src = np.random.default_rng(10).standard_normal(
        (mesh.ncells, sum(cols))).astype(np.float32)
    jkw, kw, rot = _rotated(ells, (0, 2, 2) if rotate else None)
    ref = jm.PackedSlabRegridder(list(zip(ells, cols)), backend=backend,
                                 **jkw).apply_np(src)
    pk_ = tm.PackedSlabRegridder(list(ells), CPU, **kw)
    got = pk_.apply_np(src, cols, rot)
    assert got.shape == ref.shape == ells[0].dst_shape + (10,)
    np.testing.assert_allclose(got, ref, **TOL)
    blocks = [src[:, :4], src[:, 4:9], src[:, 9]]
    np.testing.assert_array_equal(pk_.apply_np(blocks, cols, rot), got)
    strips = {}
    pk_.apply_np(blocks, cols, rot,
                 strip_sink=lambda lo, s: strips.__setitem__(lo, s))
    np.testing.assert_array_equal(
        np.concatenate([strips[k] for k in sorted(strips)], axis=2), got)
    dev = pk_(torch.from_numpy(src), cols, rot)
    ny, nx = ells[0].dst_shape
    np.testing.assert_array_equal(dev[:ny, :nx].numpy(), got)
    with pytest.raises(ValueError, match="columns"):
        pk_(torch.from_numpy(src[:, :9]), cols)


def test_packed_wide_rotation_matches_jax(problem):
    """A 300-column packed width (three fetch strips) with the wind
    window (0, 55, 55) the default run uses."""
    mesh, _, ells = problem
    cols = [280, 12, 8]
    src = np.random.default_rng(11).standard_normal(
        (mesh.ncells, sum(cols))).astype(np.float32)
    jkw, kw, rot = _rotated(ells, (0, 55, 55), seed=4)
    ref = jm.PackedSlabRegridder(list(zip(ells, cols)), backend="xla",
                                 **jkw).apply_np(src)
    got = tm.PackedSlabRegridder(list(ells), CPU, **kw).apply_np(
        src, cols, rot)
    np.testing.assert_allclose(got, ref, **TOL)


def test_rotate_window_outside_chunk_raises(problem):
    """Refused as in the JAX package, by the call, before any upload."""
    mesh, _, ells = problem
    cosa, sina = _rotation(ells[0])
    cols = [5, 3, 2]
    rg = tm.PackedSlabRegridder(list(ells), CPU, rotation=(cosa, sina))
    src = np.ones((mesh.ncells, sum(cols)), np.float32)
    t = Timings()
    with recording(t), pytest.raises(ValueError, match="rotate window"):
        rg.apply_np(src, cols, ((0, 8, 4),))
    assert "apply.upload_bytes" not in t.counts
    with pytest.raises(ValueError, match="rotate window"):
        rg(torch.from_numpy(src), cols, ((0, 8, 4),))
    with pytest.raises(ValueError, match="rotate window"):
        jm.PackedSlabRegridder(list(zip(ells, cols)),
                               rotate_spec=(((0, 8, 4),), cosa, sina))


def test_w_cap_overflow_raises():
    """A tile referencing more than W_CAP unique rows is refused, as in
    the JAX package (the pipeline then uses the gather Regridder)."""
    rng = np.random.default_rng(0)
    n_src, K = 100_000, 3
    idx = rng.integers(0, n_src, (32 * 32, K))
    ell = ELLWeights(idx=idx, w=np.full((32 * 32, K), 1.0 / K), n_src=n_src,
                     method="bilinear", dst_shape=(32, 32))
    for cls in (lambda e: tm.PackedSlabRegridder([e], CPU),
                lambda e: jm.SlabMatmulRegridder(e, backend="xla")):
        with pytest.raises(ValueError, match="unique source rows"):
            cls(ell)
    assert tm.W_CAP == jm.W_CAP


def test_precision_validated(problem):
    _, _, (ell, _, _) = problem
    assert tm.PRECISIONS == jm.PRECISIONS
    with pytest.raises(ValueError, match="precision"):
        tm.PackedSlabRegridder([ell], CPU, precision="bf16")


def test_cpu_applies_never_launch(problem, monkeypatch):
    """On the CPU every apply runs the plain version: the launch counter
    stays put, the plain counter grows by one per kernel-shaped call."""
    mesh, _, (ell, _, _) = problem
    rg = tm.PackedSlabRegridder([ell], CPU)
    src = np.ones((mesh.ncells, 700), np.float32)
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", "0.001")
    gw = rg._grouped_width(768)                   # several launch groups
    launches, plain = pk.LAUNCHES, pk.PLAIN_CALLS
    rg.apply_np(src)
    assert pk.LAUNCHES == launches
    assert pk.PLAIN_CALLS == plain + -(-768 // gw)


# ------------------------------------------------ one-hot and gather routes

PRECISIONS = ("highest", "split_bf16", "split6_bf16")


def _plain_counts():
    return pk.PLAIN_CALLS, dict(ok.PLAIN_CALLS), gk.PLAIN_CALLS


def _close(got, ref):
    """rtol 1e-6 of the largest |ref|: the one-hot route computes the JAX
    package's terms in another order of f32 sums."""
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))


def _slab_ell(mesh):
    ny, nx = 33, 34       # forces tile padding on both axes
    lat = np.linspace(-25, 25, ny)[:, None] + np.zeros((1, nx))
    lon = np.linspace(-40, 40, nx)[None, :] + np.zeros((ny, 1))
    ell = bilinear_cell_weights(mesh, lat.ravel(), lon.ravel())
    return dataclasses.replace(ell, dst_shape=(ny, nx))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_onehot_route_slab_matches_jax(small_mesh, monkeypatch, backend,
                                       precision):
    """MPASSIT_ELL_KERNEL=0: the JAX package applies its prestacked one-hot
    A (fused_apply under backend="pallas", _tile_matmul under "xla"); the
    port builds the f32 A and runs onehot_apply_packed's plain version
    over one range."""
    monkeypatch.setenv("MPASSIT_ELL_KERNEL", "0")
    ell = _slab_ell(small_mesh)
    ny, nx = ell.dst_shape
    src = np.random.default_rng(6).standard_normal(
        (small_mesh.ncells, 3)).astype(np.float32)
    jr = jm.SlabMatmulRegridder(ell, precision=precision, backend=backend)
    ref = jr.apply_np(src)
    ref_dev = np.asarray(jr(src))[:ny, :nx]
    rg = tm.PackedSlabRegridder([ell], CPU, precision=precision)
    assert rg.route == "onehot"
    (p0, o0, g0), launches = _plain_counts(), dict(ok.LAUNCHES)
    got = rg.apply_np(src)
    dev = rg(torch.from_numpy(src))
    assert pk.PLAIN_CALLS == p0 and gk.PLAIN_CALLS == g0
    assert ok.PLAIN_CALLS == {"onehot_apply_packed":
                              o0["onehot_apply_packed"] + 2}
    assert ok.LAUNCHES == launches
    assert [A.shape for A in rg.As] == [(rg.n_tiles, rg.W, 1024)]
    _close(got, ref)
    _close(dev[:ny, :nx].numpy(), ref_dev)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_onehot_route_packed_matches_jax(problem, monkeypatch, backend,
                                         precision):
    """MPASSIT_ELL_KERNEL=0 on the packed regridder, with the in-kernel
    rotation (post-unblock on the JAX xla backend)."""
    monkeypatch.setenv("MPASSIT_ELL_KERNEL", "0")
    mesh, _, ells = problem
    cols = [5, 3, 2]
    jkw, kw, rot = _rotated(ells, (0, 2, 2))
    src = np.random.default_rng(12).standard_normal(
        (mesh.ncells, sum(cols))).astype(np.float32)
    jr = jm.PackedSlabRegridder(list(zip(ells, cols)), precision=precision,
                                backend=backend, **jkw)
    ref = jr.apply_np(src)
    ref_dev = np.asarray(jr(src))
    rg = tm.PackedSlabRegridder(list(ells), CPU, precision=precision, **kw)
    assert rg.route == "onehot"
    p0, o0, g0 = _plain_counts()
    got = rg.apply_np(src, cols, rot)
    dev = rg(torch.from_numpy(src), cols, rot).numpy()
    assert pk.PLAIN_CALLS == p0 and gk.PLAIN_CALLS == g0
    assert ok.PLAIN_CALLS == {"onehot_apply_packed":
                              o0["onehot_apply_packed"] + 2}
    assert [A.shape for A in rg.As] == [(rg.n_tiles, rg.W, 1024)] * 3
    _close(got, ref)
    _close(dev, ref_dev[:dev.shape[0]])


def test_onehot_wins_over_gather(problem, monkeypatch):
    _, _, (ell, _, _) = problem
    monkeypatch.setenv("MPASSIT_GATHER_KERNEL", "1")
    monkeypatch.setenv("MPASSIT_ELL_KERNEL", "0")
    assert tm.PackedSlabRegridder([ell], CPU).route == "onehot"
    monkeypatch.setenv("MPASSIT_ELL_KERNEL", "1")
    assert tm.PackedSlabRegridder([ell], CPU).route == "gather"
    monkeypatch.delenv("MPASSIT_GATHER_KERNEL")
    assert tm.PackedSlabRegridder([ell], CPU).route == "ell"


@pytest.mark.parametrize("C", [3, 600])
def test_gather_route_slab_equals_default(problem, monkeypatch, tmp_path, C):
    """MPASSIT_GATHER_KERNEL=1: bit for bit the default route. apply_np
    and __call__ each make one gather launch at every width, past FETCH
    columns too (600 columns pad to 640): the gather route is never
    grouped. The chunk layout is cached as its own entry."""
    mesh, _, (ell, _, _) = problem
    src = np.random.default_rng(C).standard_normal(
        (mesh.ncells, C)).astype(np.float32)
    base = tm.PackedSlabRegridder([ell], CPU)
    ref, ref_dev = base.apply_np(src), base(torch.from_numpy(src))
    monkeypatch.setenv("MPASSIT_GATHER_KERNEL", "1")
    rg = tm.PackedSlabRegridder([ell], CPU, cache_dir=str(tmp_path))
    p0, o0, g0 = _plain_counts()
    got = rg.apply_np(src)
    assert gk.PLAIN_CALLS == g0 + 1 and pk.PLAIN_CALLS == p0
    np.testing.assert_array_equal(got, ref)
    assert torch.equal(rg(torch.from_numpy(src)), ref_dev)
    assert gk.PLAIN_CALLS == g0 + 2 and pk.PLAIN_CALLS == p0
    assert ok.PLAIN_CALLS == o0
    assert any(n.startswith("torchgather") for n in os.listdir(tmp_path))
    again = tm.PackedSlabRegridder([ell], CPU, cache_dir=str(tmp_path))
    ch, locs8, _ = again._gather_dev()
    assert again.W8 == rg.W8 and torch.equal(ch, rg._gather_dev()[0])
    assert torch.equal(locs8[0], rg._gather_dev()[1][0])


def test_gather_route_packed_equals_default(problem, monkeypatch):
    """The packed regridder's gather route, with the in-kernel rotation,
    bit for bit the default route (apply_np, block lists, __call__)."""
    mesh, _, ells = problem
    cols = [280, 12, 8]
    _, kw, rot = _rotated(ells, (0, 55, 55), seed=4)
    src = np.random.default_rng(13).standard_normal(
        (mesh.ncells, sum(cols))).astype(np.float32)
    base = tm.PackedSlabRegridder(list(ells), CPU, **kw)
    ref = base.apply_np(src, cols, rot)
    ref_dev = base(torch.from_numpy(src), cols, rot)
    monkeypatch.setenv("MPASSIT_GATHER_KERNEL", "1")
    rg = tm.PackedSlabRegridder(list(ells), CPU, **kw)
    assert rg.route == "gather" and rg._cosa_t is not None
    p0, o0, g0 = _plain_counts()
    np.testing.assert_array_equal(rg.apply_np(src, cols, rot), ref)
    np.testing.assert_array_equal(
        rg.apply_np([src[:, :100], src[:, 100:]], cols, rot), ref)
    assert torch.equal(rg(torch.from_numpy(src), cols, rot), ref_dev)
    assert gk.PLAIN_CALLS == g0 + 3
    assert pk.PLAIN_CALLS == p0 and ok.PLAIN_CALLS == o0
    assert rg.W8 >= rg.W and rg.W8 % tm.CH == 0
