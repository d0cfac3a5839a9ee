"""The source cells renumbered on the device as they are uploaded
(``PackedSlabRegridder``'s ``perm_inv``, ``_src_window_to_device``).

The weights are built on the mesh's cells renumbered along a Z-curve
(mesh/reorder), while the host keeps the cell-located fields in file
order. An operator built with the file-to-Morton map lands each uploaded
row at its renumbered row; one built without it takes the source already
renumbered on the host. With the map, on file-order sources, the operator
equals the same operator without it on host-renumbered sources bit for
bit: on every route (ell, onehot, gather), one group and grouped, with and
without the in-kernel rotation, for one array, a block list, a strip sink
and ``__call__``; and on a CUDA card, where the rows land by the card's
``index_copy_``. (The pipeline's side: tests/test_torch_pipeline.py.)

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_renumbered_upload.py
"""

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.config import Config
from mpassit_tpu_torch.grids.target import build_target_grid
from mpassit_tpu_torch.mesh.reorder import apply_perm, reorder_cells_morton
from mpassit_tpu_torch.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.spans import Timings, recording
from mpassit_tpu_torch.weights.bilinear import bilinear_cell_weights
from mpassit_tpu_torch.weights.conservative import conservative_weights
from mpassit_tpu_torch.weights.nearest import nearest_weights

CPU = torch.device("cpu")
COLS = [500, 80, 60]            # Cp 640 > FETCH: the budget can group it
TINY = "0.001"                  # GB: every pack here exceeds it


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for k in ("MPASSIT_DEVICE_BUDGET_GB", "MPASSIT_ELL_KERNEL",
              "MPASSIT_GATHER_KERNEL"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def problem():
    """The three cell methods' ELLs on the renumbered mesh, the map, and
    a source in the file's cell order."""
    mesh = synthetic_voronoi_mesh(ncells=3000, nz=3, nsoil=1, seed=9)
    grid = build_target_grid(Config.from_dict({
        "target_grid_type": "lambert", "nx": 65, "ny": 41, "dx": 80e3,
        "dy": 80e3, "ref_lat": 38.5, "ref_lon": -97.5, "truelat1": 38.5,
        "stand_lon": -97.5}))
    ro = reorder_cells_morton(mesh, grid.proj)
    m = ro.mesh
    ells = (bilinear_cell_weights(m, grid.lat, grid.lon),
            nearest_weights(m, grid.lat, grid.lon),
            conservative_weights(m, grid))
    src = np.random.default_rng(22).standard_normal(
        (mesh.ncells, sum(COLS))).astype(np.float32)
    assert not np.array_equal(ro.perm, np.arange(mesh.ncells))
    return ells, ro, src


def _rotation(ells):
    ny, nx = ells[0].dst_shape
    alpha = np.random.default_rng(3).uniform(-0.3, 0.3, (ny, nx))
    return np.cos(alpha).astype(np.float32), np.sin(alpha).astype(np.float32)


def _apply(rg, src, form, rot):
    """``src`` (COLS) through ``rg``: apply_np of one array, of a block
    list (a 1-D block among them), through a strip sink, or ``__call__``
    on the device result's data region."""
    if form == "array":
        return rg.apply_np(src, COLS, rot)
    blocks = [src[:, :17], src[:, 17], src[:, 18:300], src[:, 300:]]
    if form == "blocks":
        return rg.apply_np(blocks, COLS, rot)
    if form == "call":
        ny, nx = rg.dst_shape
        return rg(torch.from_numpy(src), COLS, rot)[:ny, :nx].numpy()
    strips = {}
    assert rg.apply_np(blocks, COLS, rot, strip_sink=lambda lo, s:
                       strips.__setitem__(lo, np.array(s))) is None
    return np.concatenate([strips[k] for k in sorted(strips)], axis=2)


def _route(monkeypatch, route):
    if route == "onehot":
        monkeypatch.setenv("MPASSIT_ELL_KERNEL", "0")
    if route == "gather":
        monkeypatch.setenv("MPASSIT_GATHER_KERNEL", "1")


def _pair(ells, ro, device, rotate):
    """The operator without the map and with it, and the call's rotation
    windows."""
    kw = {"rotation": _rotation(ells)} if rotate else {}
    plain = tm.PackedSlabRegridder(list(ells), device,
                                   precision="split6_bf16", **kw)
    mapped = tm.PackedSlabRegridder(list(ells), device,
                                    precision="split6_bf16",
                                    perm_inv=ro.perm_inv, **kw)
    return plain, mapped, ((0, 2, 2),) if rotate else ()


@pytest.mark.parametrize("form", ["array", "blocks", "sink", "call"])
@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("route", ["ell", "onehot", "gather"])
def test_map_equals_host_renumbering(problem, monkeypatch, route, grouped,
                                     rotate, form):
    ells, ro, src = problem
    _route(monkeypatch, route)
    plain, mapped, rot = _pair(ells, ro, CPU, rotate)
    assert mapped.route == plain.route == route
    assert plain.perm_inv is None
    assert mapped.perm_inv.dtype == torch.int64
    if grouped:
        monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", TINY)
    # the map is held on the device and counted with the operands
    assert mapped._held_bytes() == plain._held_bytes() + 8 * len(ro.perm)
    gw = mapped._grouped_width(tm.padded(sum(COLS)), rot)
    assert (gw > 0) == grouped

    ref = _apply(plain, apply_perm(src, ro.perm), form, rot)
    t = Timings()
    with recording(t):
        got = _apply(mapped, src, form, rot)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    if form == "call":
        assert "apply.upload_bytes" not in t.counts
    else:
        # every uploaded byte renumbered, once
        assert t.counts["apply.renumbered_bytes"] == \
            t.counts["apply.upload_bytes"] == src.nbytes
        assert t.counts["apply.groups"] == (
            -(-640 // gw) if grouped and route != "gather" else 1)


def test_map_length_checked(problem):
    ells, ro, _ = problem
    with pytest.raises(ValueError, match="perm_inv has"):
        tm.PackedSlabRegridder(list(ells), CPU, perm_inv=ro.perm_inv[:-1])


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's index_copy_ and "
                    "kernels)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("route", ["ell", "onehot", "gather"])
def test_map_on_the_card(problem, monkeypatch, cuda_device, route, grouped):
    """On the card, file-order blocks through the map give, bit for bit,
    what host-renumbered blocks give without it, with the rotation."""
    ells, ro, src = problem
    _route(monkeypatch, route)
    plain, mapped, rot = _pair(ells, ro, cuda_device, True)
    if grouped:
        monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", TINY)
    ref = _apply(plain, apply_perm(src, ro.perm), "blocks", rot)
    t = Timings()
    with recording(t):
        got = _apply(mapped, src, "blocks", rot)
    assert got.tobytes() == ref.tobytes()
    assert t.counts["apply.renumbered_bytes"] == src.nbytes
