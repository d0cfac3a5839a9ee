"""MPASSIT's global lat-lon target (is_regional = .false.) in the port: the
restagger's seam and poles, held to the benchmark's plain reference
(``portbench/reference``), and what the benchmark reads of it.

- The periodic edge operators (``weights/restagger.py``) on a 36 x 19
  global grid, applied to seeded smooth mass winds, against the
  reference's ``quad_bilinear`` across the seam and its pole means, at
  every point; K = 4; U at i = 0 equal to U at i = nx; each pole row of V
  constant and the mean of the mass row next to it.
- Every other grid's edge operators are the parent's: their fingerprints
  are pinned as computed before periodic grids were mapped.
- The weight cache: entries of the global grid under the old tags (the
  operators that left the seam and poles unmapped) are not read.
- The CLI through the benchmark's harness at 4 degrees passes its check;
  the ``restagger`` span and the ``restagger.wrapped_points`` and
  ``apply.slab_bytes`` counters; a streamed run writes the U and V of the
  in-memory run.
- The benchmark's configuration, cell and readers of this target."""

import types

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.config import Config
from mpassit_tpu_torch.grids.target import build_target_grid
from mpassit_tpu_torch.io import nc4
from mpassit_tpu_torch.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.run import pipeline as tpipe
from mpassit_tpu_torch.spans import Timings, recording
from mpassit_tpu_torch.weights import restagger as rs
from mpassit_tpu_torch.weights.cache import WeightCache, grid_fingerprint
from portbench import check, spec
from portbench.reference import interp
from portbench.reference.targets.latlon import LatLon
from portbench.tests.helpers import latlon_config, passes, tiny_run

from test_pipeline import make_case
from test_torch_pipeline import _port

#: MPASSIT's global mode at 36 x 19 mass points
GLOBAL = {"target_grid_type": "lat-lon", "is_regional": False, "nx": 37,
          "ny": 20, "stand_lon": 0.0}
#: grids whose edge operators must stay as they were, and the fingerprints
#: (edge1, edge2) of those operators computed before periodic grids were
#: mapped
PINNED = {
    "lambert": ({"target_grid_type": "lambert", "nx": 31, "ny": 25,
                 "dx": 150e3, "dy": 150e3, "ref_lat": 38.5,
                 "ref_lon": -97.5, "truelat1": 38.5, "stand_lon": -97.5},
                ("12020f3f786c90e6", "184096c37aacb7b9")),
    "latlon_regional": ({"target_grid_type": "lat-lon", "nx": 41, "ny": 31,
                         "dx": 1.5, "dy": 1.2, "ref_lat": 35.0,
                         "ref_lon": -100.0},
                        ("7f4e86d65fca4ceb", "9c953f2e70fa633d")),
    "mercator": ({"target_grid_type": "mercator", "nx": 31, "ny": 25,
                  "dx": 150e3, "dy": 150e3, "ref_lat": 38.5,
                  "ref_lon": -97.5, "truelat1": 20.0, "stand_lon": -97.5},
                 ("d278f15c90fb67c1", "3581cf9db5eddaed")),
    "polar": ({"target_grid_type": "polar", "nx": 31, "ny": 25,
               "dx": 150e3, "dy": 150e3, "ref_lat": 65.0,
               "ref_lon": -100.0, "truelat1": 60.0, "stand_lon": -100.0},
              ("02696d8917ef61c5", "a21bd9b652d0e6a3")),
}


def _grid(nml):
    return build_target_grid(Config.from_dict(dict(nml)))


@pytest.fixture(scope="module")
def global_grid():
    return _grid(GLOBAL)


def _mass_winds(g, ncol=3):
    """Seeded smooth (ny*nx, ncol) float64 mass values."""
    rng = np.random.default_rng(19)
    lat, lon = np.radians(g.lat).reshape(-1), np.radians(g.lon).reshape(-1)
    a = rng.uniform(-1, 1, (ncol, 3))
    return np.stack([10 + 5 * a[k, 0] * np.sin(lat) * np.cos(lon)
                     + 3 * a[k, 1] * np.cos(lat) * np.sin(2 * lon + a[k, 2])
                     for k in range(ncol)], axis=1)


def _apply(ell, src):
    return np.einsum("tk,tkc->tc", ell.w, src[ell.idx])


def _reference_restagger(which, j, i, nml, mass):
    """The reference's restagger of ``mass`` (ny*nx, C) at stagger points
    (j, i): ``quad_bilinear`` with the periodic candidates, and on V's
    pole rows the mean of the mass row next to the pole."""
    g = LatLon(nml)
    if which == "U":
        pts = interp.xyz_deg(*g.u(j, i))
        cands = interp.u_candidates(j, i, g.nx, g.periodic)
    else:
        pts = interp.xyz_deg(*g.v(j, i))
        cands = interp.v_candidates(j, i, g.ny, g.nx, g.periodic)
    idx, w = interp.quad_bilinear(
        pts, lambda jq, iq: interp.xyz_deg(*g.mass(jq, iq)), cands, g.ny,
        g.nx, g.periodic)
    out = np.einsum("tk,tkc->tc", w, mass[idx])
    if which == "V":
        out[j == 0] = mass[:g.nx].mean(axis=0)
        out[j == g.ny] = mass[-g.nx:].mean(axis=0)
    return out


# ---- the periodic operators --------------------------------------------------

@pytest.mark.parametrize("which", ["U", "V"])
def test_periodic_restagger_matches_reference(global_grid, which):
    g = global_grid
    mass = _mass_winds(g)
    if which == "U":
        ell, src = rs.edge1_weights(g), mass
        j, i = np.divmod(np.arange(g.ny * (g.nx + 1)), g.nx + 1)
    else:
        ell = rs.edge2_weights(g)
        src = rs.with_pole_rows(mass, g.ny, g.nx)
        j, i = np.divmod(np.arange((g.ny + 1) * g.nx), g.nx)
    got = _apply(ell, src)
    want = _reference_restagger(which, j, i, GLOBAL, mass)
    assert np.all(ell.mapped)
    err = np.abs(got - want) / np.abs(want).max()
    assert err.max() < 1e-6, err.max()
    edge = (i == 0) | (i == g.nx) if which == "U" else (j == 0) | (j == g.ny)
    assert edge.sum() == 2 * (g.ny if which == "U" else g.nx)


def test_periodic_operators_k4_seam_and_poles(global_grid):
    g = global_grid
    e1, e2 = rs.edge1_weights(g), rs.edge2_weights(g)
    assert (e1.k, e2.k) == (4, 4)
    assert (e1.n_src, e2.n_src) == (g.n_points, g.n_points + 2)
    e2.validate()
    mass = _mass_winds(g).astype(np.float32)
    u = _apply(e1, mass).reshape(g.ny, g.nx + 1, -1)
    np.testing.assert_array_equal(u[:, 0], u[:, g.nx])
    src = rs.with_pole_rows(mass, g.ny, g.nx)
    assert src.dtype == np.float32 and src.shape == (g.n_points + 2, 3)
    v = _apply(e2, src).reshape(g.ny + 1, g.nx, -1)
    rows = mass.reshape(g.ny, g.nx, -1)
    for vrow, mrow in ((0, 0), (g.ny, g.ny - 1)):
        assert np.all(v[vrow] == v[vrow, :1])
        np.testing.assert_allclose(
            v[vrow, 0], rows[mrow].mean(axis=0, dtype=np.float64),
            rtol=1e-6)
    assert rs.wrapped_points(g, "U") == 2 * g.ny
    assert rs.wrapped_points(g, "V") == 2 * g.nx


@pytest.mark.parametrize("kind", sorted(PINNED))
def test_other_grids_keep_their_operators(kind):
    nml, (fp1, fp2) = PINNED[kind]
    g = _grid(nml)
    assert not g.periodic
    assert (rs.edge1_weights(g).fingerprint(),
            rs.edge2_weights(g).fingerprint()) == (fp1, fp2)
    assert rs.wrapped_points(g, "U") == rs.wrapped_points(g, "V") == 0


def test_old_cache_tags_not_read_for_periodic_grid(tmp_path, global_grid):
    """A cache holding the global grid's edge operators under the tags
    ``edge1``/``edge2`` (those that left the seam and poles unmapped) is
    not read: the periodic operators are built and stored under tags of
    their own."""
    g = global_grid
    mesh = synthetic_voronoi_mesh(ncells=600, nz=3, nsoil=2, seed=3)
    cache = WeightCache(str(tmp_path))
    fpm, fpg = mesh.fingerprint(), grid_fingerprint(g)
    ny, nx = g.ny, g.nx
    old = {
        "edge1": rs.grid_bilinear_weights(
            g.lat, g.lon, g.lat_u, g.lon_u, rs._edge_candidates_u(ny, nx)),
        "edge2": rs.grid_bilinear_weights(
            g.lat, g.lon, g.lat_v, g.lon_v, rs._edge_candidates_v(ny, nx)),
    }
    for tag, ell in old.items():
        assert not ell.mapped.all()
        cache.get_or_build(tag, fpm, fpg, lambda e=ell: e)
    routing = types.SimpleNamespace(
        nstd_2d=[], cons_2d=[], vert_3d=[], do_u=True, do_v=True,
        soil_method=lambda: "bilinear")
    cfg = types.SimpleNamespace(weights_cache_dir=str(tmp_path))
    t = Timings()
    with recording(t):
        got = tpipe.build_weights(cfg, mesh, g, routing)
    # the bilinear operator and both periodic edge operators are built
    assert t.counts == {"weights.cache_misses": 3}
    for key, build in (("edge1", rs.edge1_weights),
                       ("edge2", rs.edge2_weights)):
        assert got[key].fingerprint() == build(g).fingerprint()
        assert got[key].mapped.all()
        assert cache.has(key + ".periodic", fpm, fpg)
    t = Timings()
    with recording(t):
        again = tpipe.build_weights(cfg, mesh, g, routing)
    assert t.counts == {"weights.cache_hits": 3}
    assert again["edge2"].n_src == g.n_points + 2


def test_slab_bytes_counts_each_launch():
    """``apply.slab_bytes`` of one pack: tiles x W x the launch's columns
    x 4, on the default route."""
    g = _grid(GLOBAL)
    ell = rs.edge2_weights(g)
    rg = tm.PackedSlabRegridder([ell], torch.device("cpu"))
    src = rs.with_pole_rows(_mass_winds(g).astype(np.float32), g.ny, g.nx)
    t = Timings()
    with recording(t):
        out = rg.apply_np(src)
    assert out.shape == (g.ny + 1, g.nx, 3)
    assert t.counts["apply.groups"] == 1
    assert t.counts["apply.slab_bytes"] == rg.n_tiles * rg.W * tm.LANE * 4
    np.testing.assert_allclose(out.reshape(-1, 3), _apply(ell, src),
                               rtol=1e-6, atol=1e-5)


# ---- the CLI through the benchmark's harness ---------------------------------

@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    """A run of the harness on the global 4-degree target and one on its
    Lambert test target, on the CPU."""
    mp = pytest.MonkeyPatch()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = {}
        for kind, cfg in (("global", latlon_config("global")),
                          ("lambert", None)):
            d = tmp_path_factory.mktemp("harness_" + kind)
            mp.setenv("TMPDIR", str(d))
            mp.setattr("tempfile.tempdir", None)
            out[kind] = tiny_run(d, cfg=cfg)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return out


def test_global_cli_passes_the_check(harness_runs):
    r, numbers = harness_runs["global"]
    g = r.ref.grid
    assert g.periodic and numbers["schema_faults"] == 0
    assert passes(numbers), numbers["worst"]
    assert numbers["rel_err"] < check.LIMITS["rel_err"] / 2
    # the seam's and the poles' samples are among the points compared
    (ju, iu), (jv, iv) = r.points["U"], r.points["V"]
    assert ((iu == 0) | (iu == g.nx)).sum() >= 256
    assert ((jv == 0) | (jv == g.ny)).sum() >= 256


def test_global_cli_spans_and_counters(harness_runs):
    r, _ = harness_runs["global"]
    g = r.ref.grid
    assert r.hours
    for h in r.hours:
        assert h["counts"]["restagger.wrapped_points"] == 2 * g.ny + 2 * g.nx
        assert h["counts"]["apply.slab_bytes"] > 0
        assert 0 < h["stages"]["restagger"] < h["stages"]["interp_data"]
    lam, _ = harness_runs["lambert"]
    for h in lam.hours:
        assert "restagger.wrapped_points" not in h["counts"]
        assert h["counts"]["apply.slab_bytes"] > 0
        assert "restagger" in h["stages"]


@pytest.mark.parametrize("kind", ["global", "lambert"])
def test_readers_read_the_new_span_and_counter(harness_runs, kind):
    r, _ = harness_runs[kind]
    ctx = r.context()
    hours = r.hours
    restagger_s = spec.reader("restagger_s")(ctx)
    slab_gb = spec.reader("slab_gb")(ctx)
    assert restagger_s == pytest.approx(
        sum(h["stages"]["restagger"] for h in hours) / len(hours))
    assert slab_gb == pytest.approx(
        sum(h["counts"]["apply.slab_bytes"] for h in hours)
        / len(hours) / 1e9)


def test_readers_silent_without_span_or_counter(harness_runs):
    """An hour of a program that records no ``restagger`` span and no
    ``apply.slab_bytes`` counter: both readers give None."""
    r, _ = harness_runs["lambert"]
    hours = r.hours
    r.hours = [dict(h, stages={k: v for k, v in h["stages"].items()
                               if k != "restagger"},
                    counts={k: v for k, v in h["counts"].items()
                            if k != "apply.slab_bytes"}) for h in hours]
    try:
        ctx = r.context()
        assert spec.reader("restagger_s")(ctx) is None
        assert spec.reader("slab_gb")(ctx) is None
    finally:
        r.hours = hours


# ---- streamed output ---------------------------------------------------------

def test_streamed_global_winds_equal_in_memory(tmp_path):
    _, cfg, _, _ = make_case(
        tmp_path, ncells=3000,
        cfg_overrides={
            "target_grid_type": "lat-lon", "is_regional": False,
            "nx": 37, "ny": 20, "dx": None, "dy": None, "ref_lat": None,
            "ref_lon": None, "truelat1": None, "stand_lon": 0.0})
    files = {}
    for stream in (False, True):
        pcfg = _port(cfg)
        pcfg.output_file = str(tmp_path / f"out_{stream}.nc")
        pcfg.stream_output = stream
        art = tpipe.run_pipeline(pcfg, device="cpu")
        assert art.timings.counts["restagger.wrapped_points"] == 2 * (
            19 + 36)
        files[stream] = pcfg.output_file
    with nc4.open_dataset(files[False]) as a, \
            nc4.open_dataset(files[True]) as b:
        for name in ("U", "V"):
            x, y = a.read_var(name), b.read_var(name)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        u, v = a.read_var("U")[0], a.read_var("V")[0]
    np.testing.assert_array_equal(u[..., 0], u[..., -1])
    assert np.all(v[:, 0] == v[:, 0, :1]) and np.all(v[:, -1] == v[:, -1, :1])
    assert np.abs(u[..., 0]).min() > 0 and np.abs(v[:, 0]).min() > 0


# ---- the benchmark's configuration and cell ----------------------------------

def test_global_configuration_loads():
    bench = spec.benchmark()
    cell = spec.cell(bench, "global025.warm")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "global025_x1.655362", "hourly_cached", 1)
    cfg = spec.config(cell["config"])
    conus = spec.config("conus3km_x1.655362")
    assert cfg["name"] == "global025_x1.655362" and cfg["reduced"] == []
    assert cfg["namelist"] == {
        "target_grid_type": "lat-lon", "is_regional": False, "nx": 1441,
        "ny": 721, "stand_lon": 0.0, "interp_diag": True,
        "interp_hist": True, "wrf_mod_vars": True, "esmf_log": False}
    for key in ("mesh", "inputs", "varlists"):
        assert cfg[key] == conus[key], key
    entry = [c for c in bench["configs"] if c["name"] == cfg["name"]][0]
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    g = LatLon(cfg["namelist"])
    assert (g.ny, g.nx, g.periodic) == (720, 1440, True)
    assert g.lon1 == pytest.approx(0.125)


def test_global_cell_metrics():
    bench = spec.benchmark()
    e2e = [m["name"] for m in spec.metrics_of(bench, "global025.warm",
                                              "end_to_end")]
    assert sorted(e2e) == sorted(["hour_s", "peak_host_gb",
                                  "peak_device_gb", "setup_s"])
    layer = [m["name"] for m in spec.metrics_of(bench, "global025.warm",
                                                "per_layer")]
    assert layer == ["restagger_s", "slab_gb"]
    for cell in ("conus3km.warm", "ncep218.cold"):
        got = [m["name"] for m in spec.metrics_of(bench, cell, "per_layer")]
        assert {"restagger_s", "slab_gb"} <= set(got)


def test_pole_rows_are_float64_means():
    """The pole rows are accumulated in float64, then stored in the mass
    values' dtype."""
    mass = np.full((6, 2), 0.1, np.float32)
    mass[:3, 1] = [1e8, 1.0, -1e8]
    got = rs.with_pole_rows(mass, 2, 3)
    assert got.dtype == np.float32 and got.shape == (8, 2)
    np.testing.assert_array_equal(got[:6], mass)
    assert got[6, 1] == np.float32(1.0 / 3.0)
    assert got[7, 0] == np.float32(0.1)
