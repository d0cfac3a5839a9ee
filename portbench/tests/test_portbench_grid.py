"""The reference's target grids: NCEP grid 218 comes out as published, and
the reference's Lambert grid agrees with the program's at sampled points
of both configurations."""

import numpy as np
import pytest

from portbench import spec
from portbench.reference.grid import Lambert


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
