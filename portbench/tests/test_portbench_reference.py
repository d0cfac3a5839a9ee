"""The reference on its own, without the program: what it expects of both
Lambert configurations is what it expected before the target grid was
chosen by kind (digests of every array, taken at that commit); a lat-lon
configuration, global or regional, added as a file alone, gets expected
values without SINALPHA/COSALPHA or rotated winds; the periodic grid's
restagger crosses the seam and gives the poles their row's mean; the work
``problem`` counts."""

import hashlib
import json
import os

import numpy as np
import pytest

from portbench import inputs, problem, spec
from portbench.reference import interp
from portbench.reference.expected import Reference, samples
from portbench.reference.grid import target_grid
from portbench.tests.helpers import LATLON, latlon_config, tiny_config

SEED = 2**35 + 3
#: the mesh, levels and soil levels of the test size
TEST_MESH = tiny_config()["mesh"]
#: sha256 over every array of ``Reference.expected``, as
#: ``_expected_digest`` takes it, computed with the harness before the
#: grid was chosen by kind (float64 arithmetic of numpy and scipy: a build
#: that rounds sin or atan2 otherwise gives other digests at both commits)
PARENT_DIGESTS = {
    "conus3km_x1.655362":
        "4e48de2abd0c818cb748d46bb994bed3868fead2854ed9dcc6dfbf9ef5b30109",
    "ncep218_x1.655362":
        "22a8142752ca3356de1dba98a4f36ef9ea63ec71f3a9937943259853cfd0aa11",
}


def _reference(cfg, cache, seed=SEED):
    m = cfg["mesh"]
    mesh = inputs.cached_mesh(os.path.join(cache, "mesh"), m)
    fields = inputs.make_fields(cfg["varlists"], m["nz"], m["nsoil"], seed)
    return Reference(cfg, mesh, fields, cache)


def _points(cfg, n_mass=1024, n_stag=256, seed=SEED):
    nml = cfg["namelist"]
    return samples(seed, nml["ny"] - 1, nml["nx"] - 1, n_mass, n_stag)


def _expected_digest(cfg, cache) -> str:
    h = hashlib.sha256()
    for k, e in sorted(_reference(cfg, cache).expected(_points(cfg)).items()):
        h.update(k.encode())
        if isinstance(e, str):
            h.update(e.encode())
            continue
        h.update(e.where.encode() + e.values.tobytes()
                 + repr(e.scale).encode())
        if e.fill is not None:
            h.update(e.fill.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PARENT_DIGESTS))
def test_lambert_expected_unchanged(tmp_path, name):
    """The whole of ``expected`` (P_TOP over the full grid with it) for
    each configuration's namelist and varlists on the test mesh."""
    cfg = dict(spec.config(name), mesh=dict(TEST_MESH))
    assert _expected_digest(cfg, str(tmp_path)) == PARENT_DIGESTS[name]


@pytest.mark.parametrize("kind", sorted(LATLON))
def test_latlon_configuration_is_a_file(tmp_path, monkeypatch, kind):
    """A lat-lon configuration written as a file beside the others gets a
    reference, and its expected values: no SINALPHA/COSALPHA, the 10-m
    winds as interpolated, map factors 1."""
    configs = tmp_path / "configs"
    configs.mkdir()
    cfg = latlon_config(kind)
    (configs / (cfg["name"] + ".json")).write_text(json.dumps(cfg))
    monkeypatch.setattr(spec, "CONFIGS", str(configs))
    cfg = spec.config(cfg["name"])
    ref = _reference(cfg, str(tmp_path / "cache"))
    pts = _points(cfg)
    out = ref.expected(pts)
    assert not {"SINALPHA", "COSALPHA"} & set(out)
    assert {"U", "V", "U10", "V10", "XLONG_U", "P_TOP"} <= set(out)
    for st in ("M", "U", "V"):
        key = "MAPFAC_M" if st == "M" else "MAPFAC_" + st
        assert np.all(out[key].values == 1.0)
    bil = interp.bilinear(ref.mesh, ref.mass_xyz(*pts["M"]))
    for name in ("u10", "v10"):
        assert np.array_equal(out[name.upper()].values,
                              ref.apply(*bil, ref.src(name)))


def test_lambert_expected_rotates(tmp_path):
    """The Lambert test configuration keeps SINALPHA/COSALPHA and its
    rotated 10-m winds."""
    cfg = tiny_config()
    ref = _reference(cfg, str(tmp_path))
    pts = _points(cfg)
    out = ref.expected(pts)
    assert {"SINALPHA", "COSALPHA"} <= set(out)
    bil = interp.bilinear(ref.mesh, ref.mass_xyz(*pts["M"]))
    assert not np.allclose(out["U10"].values, ref.apply(*bil,
                                                        ref.src("u10")))


def test_periodic_restagger(tmp_path):
    """On the global grid the U points of columns 0 and nx take the quad
    across the seam, halfway between columns nx - 1 and 0, and the V
    points of the outermost rows the mean of their row's mass winds."""
    ref = _reference(latlon_config("global"), str(tmp_path))
    g = ref.grid
    assert g.periodic and (g.ny, g.nx) == (45, 90)

    def wind(jq, iq):
        return np.stack([np.asarray(iq, np.float64),
                         1000.0 * np.asarray(jq, np.float64)])
    j = np.arange(g.ny)
    u0 = ref.staggered("U", j, np.zeros_like(j), wind)
    un = ref.staggered("U", j, np.full_like(j, g.nx), wind)
    assert np.abs(u0 - un).max() < 1e-9
    assert np.abs(u0[0] - (g.nx - 1) / 2.0).max() < 1e-9
    i = np.arange(g.nx)
    south = ref.staggered("V", np.zeros_like(i), i, wind)
    north = ref.staggered("V", np.full_like(i, g.ny), i, wind)
    assert np.allclose(south, [[(g.nx - 1) / 2.0], [0.0]], atol=1e-9)
    assert np.allclose(north, [[(g.nx - 1) / 2.0], [1000.0 * (g.ny - 1)]],
                       atol=1e-9)
    inner = ref.staggered("V", np.full_like(i, 10), i, wind)
    assert np.abs(inner[0] - i).max() < 1e-9


def test_regional_candidates_unchanged():
    """A grid that is not periodic maps no U point of the outermost columns
    and no V point of the outermost rows, as before."""
    j, i = np.array([0, 3, 5, 5]), np.array([0, 4, 9, 3])
    u = interp.u_candidates(j, i, 9)
    assert (u[[0, 2]] == -1).all() and (u[1] == [[3, 3], [2, 3]]).all()
    v = interp.v_candidates(np.array([0, 5, 2]), np.array([4, 2, 0]), 5, 9)
    assert (v[:2] == -1).all() and (v[2] == [[1, 0], [1, -1]]).all()


#: ``problem.apply_bytes`` and ``fetch_bytes`` of the Lambert
#: configurations before the grid was chosen by kind (655,362 cells,
#: 1,310,720 vertices, 7,654,321 conservative overlaps)
PARENT_BYTES = {"conus3km_x1.655362": (11392690960, 7014437200),
                "ncep218_x1.655362": (3699356568, 966252632)}


@pytest.mark.parametrize("name", sorted(PARENT_BYTES))
def test_lambert_problem_unchanged(name):
    cfg = spec.config(name)
    g = target_grid(cfg["namelist"])
    assert (problem.apply_bytes(cfg, g, 655362, 1310720, 7654321),
            problem.fetch_bytes(cfg, g.ny, g.nx)) == PARENT_BYTES[name]


def test_periodic_problem_counts_the_seam_and_poles():
    """On the global grid every U point is mapped, the seam's two columns
    one value (4 ny nx nonzeros); each pole's V row is one mean over nx
    mass points (2 nx more than the inner rows' 4 (ny - 1) nx); nothing is
    rotated."""
    cfg = dict(tiny_config(), namelist=latlon_config("global")["namelist"])
    g = target_grid(cfg["namelist"])

    class Regional:
        ny, nx, periodic, rotates = g.ny, g.nx, False, False
    c = problem.columns(cfg)
    assert c["do_u"] and c["do_v"] and c["rotate10"]
    wide = problem.apply_bytes(cfg, g, 2562, 5120, 100)
    narrow = problem.apply_bytes(cfg, Regional, 2562, 5120, 100)
    assert wide - narrow == (4 * g.ny + 2 * g.nx) * problem.NNZ_BYTES

    class Rotating(Regional):
        rotates = True
    rot = problem.apply_bytes(cfg, Rotating, 2562, 5120, 100)
    assert rot - narrow == 6 * g.ny * g.nx * problem.F32
