"""The reference's target grids: the kind of the namelist picks the file
that works the grid out; NCEP grid 218 comes out as published; the
reference's Lambert grid agrees with the program's at sampled points of
both configurations, its lat-lon grid at a global 0.25-degree and a
regional namelist; the cache keys of the Lambert grids are the harness's
first ones."""

import numpy as np
import pytest

from portbench import spec
from portbench.reference import grid
from portbench.reference.grid import Lambert

#: MPASSIT's global lat-lon target at 0.25 degrees (1440 x 720 mass points)
GLOBAL_025 = {"target_grid_type": "lat-lon", "is_regional": False,
              "nx": 1441, "ny": 721, "stand_lon": 0.0}
REGIONAL = {"target_grid_type": "lat-lon", "nx": 301, "ny": 201,
            "dx": 0.1, "dy": 0.08, "ref_lat": 35.5, "ref_lon": -100.25}


def _port_grid(nml):
    from mpassit_tpu_torch.config import Config
    from mpassit_tpu_torch.grids.target import target_grid_from_params

    return target_grid_from_params(Config.from_dict(dict(nml)))


def test_grid_218_as_published():
    """614 x 428 mass points, the first at 12.190N 226.514E (NCEP's GRIB
    grid table), in the program and the reference alike."""
    nml = spec.config("ncep218_x1.655362")["namelist"]
    g = _port_grid(nml)
    assert g.lat.shape == (428, 614)
    assert abs(g.lat[0, 0] - 12.190) < 1e-9
    assert abs(np.mod(g.lon[0, 0], 360.0) - 226.514) < 1e-9
    ref = Lambert(nml)
    assert (ref.ny, ref.nx) == (428, 614)
    la, lo = ref.mass(0, 0)
    assert abs(la - 12.190) < 1e-9 and abs(np.mod(lo, 360) - 226.514) < 1e-9


@pytest.mark.parametrize("name", ["conus3km_x1.655362", "ncep218_x1.655362"])
def test_reference_grid_matches_the_program(name):
    nml = spec.config(name)["namelist"]
    g = _port_grid(nml)
    ref = Lambert(nml)
    rng = np.random.default_rng(3)
    j = np.concatenate([[0, ref.ny - 1], rng.integers(0, ref.ny, 300)])
    i = np.concatenate([[0, ref.nx - 1], rng.integers(0, ref.nx, 300)])
    la, lo = ref.mass(j, i)
    assert np.abs(la - g.lat[j, i]).max() < 1e-9
    assert np.abs(lo - g.lon[j, i]).max() < 1e-9
    ca, sa = ref.rotation(j, i)
    assert np.abs(ca - g.cosa[j, i]).max() < 1e-9
    assert np.abs(sa - g.sina[j, i]).max() < 1e-9
    assert np.abs(ref.mapfac(la) - g.mapfac_m[j, i]).max() < 1e-9
    ju, iu = j, np.minimum(i + 1, ref.nx)
    la, lo = ref.u(ju, iu)
    assert np.abs(la - g.lat_u[ju, iu]).max() < 1e-9
    la, lo = ref.corner(j, i)
    assert np.abs(lo - g.lon_corner[j, i]).max() < 1e-9


@pytest.mark.parametrize("kind,cls", [("lambert", "Lambert"),
                                      ("lat-lon", "LatLon"),
                                      (" Lat-Lon ", "LatLon")])
def test_kind_picks_its_file(kind, cls):
    mod = grid.module(kind)
    assert hasattr(mod, cls) and callable(mod.grid)


def test_unknown_kind_names_its_file():
    with pytest.raises(ValueError, match=r"targets/polarwgs84\.py is missing"):
        grid.target_grid({"target_grid_type": "polar-wgs84"})
    with pytest.raises(ValueError, match="names no file"):
        grid.module("../grid")


def test_a_new_kind_is_one_file(tmp_path, monkeypatch):
    """A projection the harness does not know is added by its file."""
    (tmp_path / "cassini.py").write_text(
        "class G:\n    rotates = periodic = False\n\n\n"
        "def grid(nml):\n    g = G()\n    g.nx = nml['nx'] - 1\n"
        "    return g\n")
    monkeypatch.setattr(grid, "TARGETS", str(tmp_path))
    g = grid.target_grid({"target_grid_type": "cassini", "nx": 11})
    assert g.nx == 10 and not g.rotates


@pytest.mark.parametrize("name", ["conus3km_x1.655362", "ncep218_x1.655362"])
def test_lambert_cache_keys_unchanged(name):
    """The keys of the full-grid bilinear weights (``refbilinear_*.npz``)
    and of the conservative overlap count are those the harness wrote
    before the grid was chosen by kind, so a checkout's caches still hit."""
    g = grid.target_grid(spec.config(name)["namelist"])
    assert g.rotates and not g.periodic
    assert g.cache_key("bilinear") == (g.ny, g.nx, g.n, g.F, g.lon0, g.i1,
                                       g.j1, g.X1, g.Y1, g.dx)
    assert g.cache_key("overlaps") == (
        f"{g.ny}x{g.nx}:{g.n!r}:{g.X1!r}:{g.Y1!r}:{g.dx!r}")


def _sampled(ref, rng, n=400):
    j = np.concatenate([[0, 0, ref.ny, ref.ny], rng.integers(0, ref.ny + 1,
                                                             n)])
    i = np.concatenate([[0, ref.nx, 0, ref.nx], rng.integers(0, ref.nx + 1,
                                                             n)])
    return j, i


@pytest.mark.parametrize("nml", [GLOBAL_025, REGIONAL],
                         ids=["global_025", "regional"])
def test_latlon_grid_matches_the_program(nml):
    """Every stagger's latitude, longitude and map factor at sampled points,
    the outermost rows and columns among them, to 1e-9."""
    g = _port_grid(nml)
    ref = grid.target_grid(nml)
    assert (ref.ny, ref.nx) == g.lat.shape
    assert not ref.rotates and g.cosa is None
    assert ref.periodic == (not nml.get("is_regional", True))
    j, i = _sampled(ref, np.random.default_rng(5))
    for fn, lat, lon, mf, (nj, ni) in (
            (ref.mass, g.lat, g.lon, g.mapfac_m, (ref.ny, ref.nx)),
            (ref.u, g.lat_u, g.lon_u, g.mapfac_u, (ref.ny, ref.nx + 1)),
            (ref.v, g.lat_v, g.lon_v, g.mapfac_v, (ref.ny + 1, ref.nx)),
            (ref.corner, g.lat_corner, g.lon_corner, None,
             (ref.ny + 1, ref.nx + 1))):
        jj, ii = np.minimum(j, nj - 1), np.minimum(i, ni - 1)
        la, lo = fn(jj, ii)
        assert np.abs(la - lat[jj, ii]).max() < 1e-9
        assert np.abs(lo - lon[jj, ii]).max() < 1e-9
        if mf is not None:
            assert np.abs(ref.mapfac(la) - mf[jj, ii]).max() < 1e-9


def test_global_latlon_seam_and_poles():
    """MPASSIT's global grid: 1440 x 720 mass points 0.25 degrees apart,
    the first at (-89.875, 0.125); the U points of the first and last
    columns on one meridian; the V points of the outermost rows on the
    poles."""
    ref = grid.target_grid(GLOBAL_025)
    assert (ref.ny, ref.nx) == (720, 1440) and ref.periodic
    la, lo = ref.mass(0, 0)
    assert (la, lo) == (-89.875, 0.125)
    j = np.arange(0, ref.ny, 37)
    assert np.array_equal(ref.u(j, 0)[1], ref.u(j, ref.nx)[1])
    i = np.arange(0, ref.nx, 53)
    assert np.all(ref.v(0, i)[0] == -90.0) and np.all(
        ref.v(ref.ny, i)[0] == 90.0)
