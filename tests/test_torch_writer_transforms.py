"""The writer's transforms (quirk Q7: T - 300, PB = P_HYD, P_TOP, Z_C
midpoints, PHB * 9.81) on whole arrays: every element of every variable
the port's in-memory and streamed writers put in the file, bit for bit
the JAX package's ``write_output``, for float32 and float64 input, with
``wrf_mod_vars`` on and off.

The data makes a transform done in the wrong precision show: PHB values
whose float32 product with 9.81 differs from the float64 one rounded
once, zgrid levels whose float32 sum overflows, theta over 150-3000 K and
near 300, float64 inputs that round twice when cast first, and a P_HYD
top level partly below 10 (P_TOP's selection). Beside the files: what
each writer hands the file (dtype, shape, memory layout, bytes) against
what the JAX package's hands it, and the ``write.f64_bytes`` counter."""

import types

import h5py
import numpy as np
import pytest

from mpassit_tpu.io import wrf_writer as j_writer
from mpassit_tpu_torch.config import Config
from mpassit_tpu_torch.constants import PROJ_LC
from mpassit_tpu_torch.io import wrf_writer as t_writer
from mpassit_tpu_torch.spans import Timings, recording

# the zgrid values whose float32 sum overflows overflow, on purpose, in
# PHB * 9.81 too, in both packages' writers
pytestmark = pytest.mark.filterwarnings(
    "ignore:overflow encountered:RuntimeWarning")

NX, NY, NZ, NSOIL = 37, 29, 6, 3
DTYPES = {"float32": np.float32, "float64": np.float64}


def _cfg(wrf_mod):
    cfg = Config()
    cfg.dx, cfg.ref_lat, cfg.ref_lon = 3000.0, 38.5, -97.5
    cfg.truelat1, cfg.truelat2, cfg.stand_lon = 38.5, 38.5, -97.5
    cfg.proj_code, cfg.map_proj_char = PROJ_LC, "Lambert Conformal"
    cfg.interp_diag, cfg.wrf_mod_vars = True, wrf_mod
    return cfg


def _grid(rng):
    def g(ny, nx):
        return rng.uniform(-1.0, 1.0, (ny, nx))
    return types.SimpleNamespace(
        nx=NX, ny=NY, lon=g(NY, NX), lat=g(NY, NX), lon_u=g(NY, NX + 1),
        lat_u=g(NY, NX + 1), lon_v=g(NY + 1, NX), lat_v=g(NY + 1, NX),
        mapfac_m=g(NY, NX), mapfac_u=g(NY, NX + 1), mapfac_v=g(NY + 1, NX),
        sina=g(NY, NX), cosa=g(NY, NX), hgt=g(NY, NX))


DATA = types.SimpleNamespace(
    start_time="2024-05-01_00:00:00", valid_time="2024-05-01_03:00:00",
    config_dt=20.0, lsm_scheme="noah", mp_scheme="thompson",
    conv_scheme="off", diag_out_interval=3600)

#: (category, out_name, levels or None for 2-D)
FIELDS = [("diag2d", "REFL", None), ("diag3d", "CLDFRA", NZ),
          ("cons2d", "SNOW", None), ("patch2d", "T2", None),
          ("nstd2d", "IVGTYP", None), ("soil", "SMOIS", NSOIL),
          ("nz3d", "T", NZ), ("nz3d", "QVAPOR", NZ), ("nz3d", "P_HYD", NZ),
          ("nz3d", "MUB", NZ), ("nzp13d", "PHB", NZ + 1),
          ("nzp13d", "W", NZ + 1), ("vert3d", "VORT", NZ)]


def _values(rng, name, nlev):
    shape = (NY, NX) if nlev is None else (NY, NX, nlev)
    if name == "T":
        # theta over 150-3000 K, a quarter of it within 1e-3 of 300
        th = rng.uniform(150.0, 3000.0, shape)
        near = rng.random(shape) < 0.25
        th[near] = 300.0 + rng.uniform(-1e-3, 1e-3, near.sum())
        th.flat[0] = 300.0
        return th
    if name == "P_HYD":
        p = rng.uniform(2e3, 1.05e5, shape)
        p[:, :, -1] = rng.uniform(0.0, 40.0, (NY, NX))   # partly below 10
        return p
    if name == "PHB":
        z = np.sort(rng.uniform(0.0, 3e4, shape), axis=2)
        z[0, 0, 2:4] = 3.2e38          # a float32 sum of these overflows
        return z
    return rng.normal(0.0, 1e3, shape)


def _case(dtype, seed=7):
    """(grid, RegridResult, plan, blocks): every field a view into one
    (ny, nx, columns) array of ``dtype``, as the apply's fetch gives
    them; ``blocks`` the streamed writer's puts, in strips of up to four
    levels."""
    rng = np.random.default_rng(seed)
    vals = [_values(rng, name, nlev) for _, name, nlev in FIELDS]
    u = rng.normal(0.0, 20.0, (NY, NX + 1, NZ)).astype(dtype)
    v = rng.normal(0.0, 20.0, (NY + 1, NX, NZ)).astype(dtype)
    cols = sum(1 if x.ndim == 2 else x.shape[2] for x in vals)
    big = np.empty((NY, NX, cols), dtype)
    res = t_writer.RegridResult(nz=NZ, nzp1=NZ + 1, nsoil=NSOIL, u=u, v=v,
                                zs=np.arange(1.0, NSOIL + 1.0))
    plan = {"do_u": True, "do_v": True}
    blocks, c = [], 0
    for (cat, name, nlev), x in zip(FIELDS, vals):
        k = 1 if nlev is None else nlev
        big[:, :, c:c + k] = x.reshape(NY, NX, k)
        view = big[:, :, c] if nlev is None else big[:, :, c:c + k]
        c += k
        getattr(res, cat).append((name, view, "u", "d " + name))
        plan.setdefault(cat, []).append((name, "u", "d " + name))
        if nlev is None:
            blocks.append((name, 0, view))
        else:
            blocks += [(name, l0, view[:, :, l0:l0 + 4])
                       for l0 in range(0, nlev, 4)]
    blocks += [("U", 0, u), ("V", 0, v)]
    grid = _grid(rng)
    res.hgt = grid.hgt
    return grid, res, plan, blocks


def _assert_bits_show(res, dtype):
    """The data tells a transform in the wrong precision from the right
    one."""
    (phb,) = [a for n, a, _, _ in res.nzp13d if n == "PHB"]
    (th,) = [a for n, a, _, _ in res.nz3d if n == "T"]
    (phyd,) = [a for n, a, _, _ in res.nz3d if n == "P_HYD"]
    x = phb.astype(np.float32)
    with np.errstate(over="ignore"):
        f32 = x * np.float32(9.81)
        assert (f32 != (phb * np.float64(9.81)).astype(np.float32)).any()
        assert np.isinf(x[:, :, 1:] + x[:, :, :-1]).any()
    mid = (0.5 * (phb[:, :, 1:] + phb[:, :, :-1].astype(np.float64)))
    assert np.isfinite(mid).all()
    assert th.min() < 160 and th.max() > 2900
    assert (np.abs(th - 300.0) < 1e-3).sum() > 100
    top = phyd[:, :, -1]
    assert (top < 10.0).any() and (top >= 10.0).any()
    if dtype == np.float64:
        t32 = (th.astype(np.float32) - np.float32(300.0))
        assert (t32 != (th - 300.0).astype(np.float32)).any()
        m32 = np.float32(0.5) * (phb[:, :, 1:].astype(np.float32)
                                 + phb[:, :, :-1].astype(np.float32))
        with np.errstate(invalid="ignore"):
            assert (m32 != mid.astype(np.float32)).any()


def _write(mod, writer, path, cfg, grid, res, plan, blocks):
    if writer == "in_memory":
        mod.write_output(path, cfg, grid, DATA, res)
        return
    w = mod.StreamingWriter(path, cfg, grid, DATA, plan, NZ, NZ + 1, NSOIL,
                            res.zs).open()
    w.put("HGT", 0, grid.hgt)
    for var, lev0, blk in blocks:
        w.put(var, lev0, blk)
    w.finish()


@pytest.fixture(autouse=True)
def _row_blocks(monkeypatch):
    """Z_C's midpoints in blocks of four rows (29 rows: 8 blocks, the last
    of one row)."""
    monkeypatch.setattr(t_writer, "_BLOCK_BYTES", NZ * NX * 8 * 4)


@pytest.mark.parametrize("wrf_mod", [True, False], ids=["wrf_mod", "plain"])
@pytest.mark.parametrize("writer", ["in_memory", "streamed"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_file_equals_jax_write_output(tmp_path, dtype, writer, wrf_mod):
    grid, res, plan, blocks = _case(DTYPES[dtype])
    _assert_bits_show(res, DTYPES[dtype])
    cfg = _cfg(wrf_mod)
    ref, got = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    j_writer.write_output(ref, cfg, grid, DATA, res)
    _write(t_writer, writer, got, cfg, grid, res, plan, blocks)
    with h5py.File(ref) as a, h5py.File(got) as b:
        assert list(a) == list(b)
        for name in a:
            x, y = a[name], b[name]
            assert x.shape == y.shape and x.dtype == y.dtype, name
            if x.id.get_offset() is None and y.id.get_offset() is None:
                continue                      # dimension scales: fill
            assert x[...].tobytes() == y[...].tobytes(), name
        zc = b["Z_C"][...]
        assert (zc[0, NZ] == t_writer.NC_FILL_FLOAT).all()
        assert np.isfinite(zc[0, :NZ]).all()
        assert ("T" in b and "P_TOP" in b and "PB" in b) == wrf_mod


class _Handed:
    """A ``NetCDF4File`` stand-in that keeps, for each call that hands it
    data, the variable's name and offset and the array's dtype, shape,
    strides and bytes."""

    def __init__(self, log):
        self.log, self.dims, self.vars = log, {}, {}
        self._f = self

    def __getitem__(self, name):
        return np.zeros(self.vars[name], np.float32) + t_writer.NC_FILL_FLOAT

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass

    def close(self):
        pass

    def create_dim(self, name, size):
        self.dims[name] = size or 1

    def ensure_unlimited_size(self, name, size):
        pass

    def set_attr(self, *a, **k):
        pass

    def has_var(self, name):
        return name in self.vars

    def create_var(self, name, dims, dtype, data=None):
        self.vars[name] = tuple(self.dims[d] for d in dims)
        if data is not None:
            self.write_var_slab(name, data, None)

    def write_var(self, name, data):
        self.write_var_slab(name, data, None)

    def write_var_slab(self, name, data, starts):
        a = np.asarray(data)
        # the stride of an axis of length one says nothing of the layout
        strides = tuple(s if n > 1 else 0
                        for n, s in zip(a.shape, a.strides))
        self.log.append((name, starts, a.dtype.str, a.shape, strides,
                         a.tobytes()))


@pytest.mark.parametrize("writer", ["in_memory", "streamed"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_file_is_handed_what_jax_hands_it(monkeypatch, dtype, writer):
    """The same calls, in the same order, each with a float32 array of the
    same shape, strides and bytes as the JAX package's writer gives: no
    strided view into the apply's result, no other memory order."""
    grid, res, plan, blocks = _case(DTYPES[dtype])
    cfg = _cfg(True)
    logs = {}
    for key, mod in (("jax", j_writer), ("port", t_writer)):
        logs[key] = []
        monkeypatch.setattr(mod, "NetCDF4File",
                            lambda path, mode="w", log=logs[key]:
                            _Handed(log))
        _write(mod, writer, "unused.nc", cfg, grid, res, plan, blocks)
    assert len(logs["port"]) == len(logs["jax"]) > 30
    for j, p in zip(logs["jax"], logs["port"]):
        assert p[:5] == j[:5], (p[:5], j[:5])
        assert p[5] == j[5], p[0]
        assert p[2] in ("<f4", "|S1", "<i4"), p[0]


def _counted(writer, dtype, wrf_mod, drop=()):
    grid, res, plan, blocks = _case(DTYPES[dtype])
    res.nzp13d = [e for e in res.nzp13d if e[0] not in drop]
    plan["nzp13d"] = [e for e in plan["nzp13d"] if e[0] not in drop]
    blocks = [b for b in blocks if b[0] not in drop]
    rec = Timings()
    with recording(rec), pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_writer, "NetCDF4File",
                   lambda path, mode="w": _Handed([]))
        _write(t_writer, writer, "unused.nc", _cfg(wrf_mod), grid, res,
               plan, blocks)
    return rec.counts.get("write.f64_bytes", 0)


@pytest.mark.parametrize("writer", ["in_memory", "streamed"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_f64_bytes_counts_only_z_c_scratch(dtype, writer):
    """The writer's float64 arrays are Z_C's midpoint scratch alone: one
    row block of four rows (in memory) or one plane (streamed), well
    under PHB's float64 size plus the P_TOP plane; the same for float64
    input (its transforms cast through the ufuncs' own buffers) and with
    ``wrf_mod_vars`` off (zgrid's midpoints and * 9.81 are not WRF
    extras). A run without zgrid makes none."""
    n = _counted(writer, dtype, True)
    scratch = NZ * 4 * NX * 8 if writer == "in_memory" else NY * NX * 8
    assert n == scratch
    assert 0 < n <= (NZ + 1) * NY * NX * 8 + NY * NX * 8
    assert _counted(writer, dtype, False) == scratch
    assert _counted(writer, dtype, True, drop=("PHB",)) == 0
