"""The port's own host layers (mpassit_tpu_torch/{config, grids, mesh,
weights, fields, io, native, parallel/decomp}) against the JAX package's,
on the same small inputs: every array byte for byte (dtype, shape and
bits), every scalar equal. One parametrised test, one case per layer."""

import dataclasses
import math
import os
import shutil

import numpy as np
import pytest

import mpassit_tpu.config as j_config
import mpassit_tpu.fields.registry as j_registry
import mpassit_tpu.grids.target as j_target
import mpassit_tpu.io.mpas_reader as j_reader
import mpassit_tpu.mesh.mpas as j_mpas
import mpassit_tpu.mesh.reorder as j_reorder
import mpassit_tpu.mesh.synthetic as j_synth
import mpassit_tpu.native as j_native
import mpassit_tpu.parallel.decomp as j_decomp
import mpassit_tpu.weights.bilinear as j_bilinear
import mpassit_tpu.weights.cache as j_cache
import mpassit_tpu.weights.conservative as j_conservative
import mpassit_tpu.weights.nearest as j_nearest
import mpassit_tpu.weights.restagger as j_restagger
import mpassit_tpu_torch.config as t_config
import mpassit_tpu_torch.fields.registry as t_registry
import mpassit_tpu_torch.grids.target as t_target
import mpassit_tpu_torch.io.mpas_reader as t_reader
import mpassit_tpu_torch.mesh.mpas as t_mpas
import mpassit_tpu_torch.mesh.reorder as t_reorder
import mpassit_tpu_torch.mesh.synthetic as t_synth
import mpassit_tpu_torch.native as t_native
import mpassit_tpu_torch.parallel.decomp as t_decomp
import mpassit_tpu_torch.weights.bilinear as t_bilinear
import mpassit_tpu_torch.weights.cache as t_cache
import mpassit_tpu_torch.weights.conservative as t_conservative
import mpassit_tpu_torch.weights.nearest as t_nearest
import mpassit_tpu_torch.weights.restagger as t_restagger
from mpassit_tpu_torch.testing import (
    write_data_file_classic,
    write_grid_file_classic,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAMBERT = {"target_grid_type": "lambert", "nx": 31, "ny": 25, "dx": 150e3,
           "dy": 150e3, "ref_lat": 38.5, "ref_lon": -97.5, "truelat1": 38.5,
           "stand_lon": -97.5}
LATLON = {"target_grid_type": "lat-lon", "is_regional": False, "nx": 37,
          "ny": 19, "stand_lon": 0.0}


def assert_same(a, b, path="value"):
    """Byte-for-byte equality of arrays, equality of everything else,
    recursing into dataclasses, dicts and sequences."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert np.ascontiguousarray(a).tobytes() == \
            np.ascontiguousarray(b).tobytes(), path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                assert_same(getattr(a, f.name), getattr(b, f.name),
                            f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _grids(overrides):
    return (j_target.build_target_grid(j_config.Config.from_dict(
                dict(overrides))),
            t_target.build_target_grid(t_config.Config.from_dict(
                dict(overrides))))


@pytest.fixture(scope="module")
def meshes():
    return (j_synth.synthetic_voronoi_mesh(ncells=1500, nz=3, nsoil=2,
                                           seed=7),
            t_synth.synthetic_voronoi_mesh(ncells=1500, nz=3, nsoil=2,
                                           seed=7))


@pytest.fixture(scope="module")
def lambert():
    return _grids(LAMBERT)


def case_config(meshes, lambert, tmp_path):
    path = os.path.join(REPO, "parm", "namelist.input")
    assert_same(j_config.Config.from_namelist(path, check_files=False),
                t_config.Config.from_namelist(path, check_files=False))


def case_grid_lambert(meshes, lambert, tmp_path):
    assert_same(*lambert)


def case_grid_latlon(meshes, lambert, tmp_path):
    assert_same(*_grids(LATLON))


def case_mesh(meshes, lambert, tmp_path):
    assert_same(*meshes)
    assert meshes[0].fingerprint() == meshes[1].fingerprint()


def case_morton(meshes, lambert, tmp_path):
    (jm, tm), (jg, tg) = meshes, lambert
    jr = j_reorder.reorder_cells_morton(jm, jg.proj)
    tr = t_reorder.reorder_cells_morton(tm, tg.proj)
    assert_same(jr.perm, tr.perm)
    assert_same(jr.mesh, tr.mesh)
    assert_same(j_reorder.reorder_cells_by_latitude(jm).perm,
                t_reorder.reorder_cells_by_latitude(tm).perm)


def _ell_case(build_j, build_t):
    def case(meshes, lambert, tmp_path):
        (jm, tm), (jg, tg) = meshes, lambert
        j, t = build_j(jm, jg), build_t(tm, tg)
        assert_same(j, t)
        assert j.fingerprint() == t.fingerprint()
    return case


case_ell_bilinear = _ell_case(
    lambda m, g: j_bilinear.bilinear_cell_weights(m, g.lat, g.lon),
    lambda m, g: t_bilinear.bilinear_cell_weights(m, g.lat, g.lon))
case_ell_vertex = _ell_case(
    lambda m, g: j_bilinear.bilinear_vertex_weights(m, g.lat, g.lon),
    lambda m, g: t_bilinear.bilinear_vertex_weights(m, g.lat, g.lon))
case_ell_nearest = _ell_case(
    lambda m, g: j_nearest.nearest_weights(m, g.lat, g.lon),
    lambda m, g: t_nearest.nearest_weights(m, g.lat, g.lon))
case_ell_conserve = _ell_case(
    lambda m, g: j_conservative.conservative_weights(m, g),
    lambda m, g: t_conservative.conservative_weights(m, g))
case_ell_edge1 = _ell_case(lambda m, g: j_restagger.edge1_weights(g),
                           lambda m, g: t_restagger.edge1_weights(g))
case_ell_edge2 = _ell_case(lambda m, g: j_restagger.edge2_weights(g),
                           lambda m, g: t_restagger.edge2_weights(g))


def case_weight_cache(meshes, lambert, tmp_path):
    """One cache directory, both packages: each reads the other's entry
    under the same key."""
    (jm, tm), (jg, tg) = meshes, lambert
    assert j_cache.grid_fingerprint(jg) == t_cache.grid_fingerprint(tg)
    fp = (jm.fingerprint(), j_cache.grid_fingerprint(jg))
    d = str(tmp_path / "w")
    built = j_cache.WeightCache(d).get_or_build(
        "bilinear", *fp,
        lambda: j_bilinear.bilinear_cell_weights(jm, jg.lat, jg.lon))
    got = t_cache.WeightCache(d).get_or_build(
        "bilinear", *fp, lambda: pytest.fail("port missed the JAX entry"))
    assert_same(built, got)
    built = t_cache.WeightCache(d).get_or_build(
        "nearest", *fp, lambda: t_nearest.nearest_weights(tm, tg.lat, tg.lon))
    got = j_cache.WeightCache(d).get_or_build(
        "nearest", *fp, lambda: pytest.fail("JAX missed the port's entry"))
    assert_same(built, got)


def case_reader(meshes, lambert, tmp_path):
    """Grid, diag and hist files read by both packages' readers."""
    mesh = meshes[1]
    d = str(tmp_path)
    f2 = np.sin(np.deg2rad(mesh.lat_cell)) * np.cos(np.deg2rad(
        mesh.lon_cell))
    lev = np.linspace(0, 1, mesh.nz)
    attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 60.0,
             "config_lsm_scheme": "noah",
             "config_microp_scheme": "mp_thompson"}
    write_grid_file_classic(mesh, os.path.join(d, "grid.nc"))
    write_data_file_classic(
        mesh, os.path.join(d, "diag.nc"), {"u10": 5 + f2, "t2m": 280 + f2},
        attrs={**attrs, "output_interval": 60},
        xtime="2024-03-25_10:00:00")
    write_data_file_classic(
        mesh, os.path.join(d, "hist.nc"),
        {"skintemp": 285 + f2, "theta": 300 + f2[:, None] + lev,
         "uReconstructZonal": 10 + f2[:, None] + lev,
         "uReconstructMeridional": -3 + f2[:, None] + lev,
         "tslb": 275 + f2[:, None] + np.linspace(0, 1, mesh.nsoil)},
        attrs=attrs, xtime="2024-03-25_10:00:00")
    for name, body in (("diaglist", "u10 U10\nt2m T2\n"),
                       ("histlist_2d", "skintemp TSK\n"),
                       ("histlist_3d", "theta T\nuReconstructZonal U\n"
                                       "uReconstructMeridional V\n"),
                       ("histlist_soil", "tslb TSLB\n")):
        with open(os.path.join(d, name), "w") as f:
            f.write(body)
    got = []
    for reg, rd, mp in ((j_registry, j_reader, j_mpas),
                        (t_registry, t_reader, t_mpas)):
        routing = reg.build_routing(d, True, True, True)
        data = rd.InputData()
        rd.read_diag_data(os.path.join(d, "diag.nc"), routing, data, True)
        rd.read_hist_data(os.path.join(d, "hist.nc"), routing, data)
        got.append((mp.mesh_from_file(os.path.join(d, "grid.nc")), routing,
                    data))
    assert_same(*got)
    decomp = os.path.join(d, "decomp")
    np.savetxt(decomp, np.arange(mesh.ncells) % 3, fmt="%d")
    assert_same(j_decomp.read_block_decomp_file(decomp, mesh.ncells),
                t_decomp.read_block_decomp_file(decomp, mesh.ncells))


def _native_libs():
    if shutil.which("g++") is None:
        pytest.skip("no g++: neither native library can be built")
    libs = j_native.get_lib(), t_native.get_lib()
    assert None not in libs, libs
    assert t_native._SO.startswith(os.path.join(
        os.path.dirname(t_native.__file__), "_build"))


def case_native_clip_pairs(meshes, lambert, tmp_path):
    _native_libs()
    rng = np.random.default_rng(11)
    n, vmax = 400, 7
    quad = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    quad = quad[None] * rng.uniform(0.5, 2, (n, 1, 1)) \
        + rng.uniform(-1, 1, (n, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, vmax)), axis=1)
    rad = rng.uniform(0.3, 1.5, (n, 1))
    spoly = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    scnt = rng.integers(2, vmax + 1, n).astype(np.int32)
    assert_same(j_native.clip_pairs(quad, spoly, scnt),
                t_native.clip_pairs(quad, spoly, scnt))


def case_native_bary_locate(meshes, lambert, tmp_path):
    _native_libs()
    rng = np.random.default_rng(12)
    n, ntri, ntris = 300, 5, 50

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    pts = unit(rng.standard_normal((n, 3)))
    tri = unit(pts[rng.integers(0, n, ntris)][:, None]
               + 0.3 * rng.standard_normal((ntris, 3, 3)))
    cand = rng.integers(-1, ntris, (n, ntri))
    assert_same(j_native.bary_locate(pts, cand, tri),
                t_native.bary_locate(pts, cand, tri))


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_host_layer_equals_jax_package(case, meshes, lambert, tmp_path):
    CASES[case](meshes, lambert, tmp_path)
