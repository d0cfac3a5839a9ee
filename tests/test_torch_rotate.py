"""mpassit_tpu_torch.ops.rotate against mpassit_tpu.ops.rotate (quirk Q4,
register R11): the same sequential update, at the angles and within the
f32 error bounds of tests/test_rotate_extreme.py."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.ops import rotate as jrot
from mpassit_tpu_torch.ops import rotate as trot


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _matrix_truth(u, v, cosa, sina):
    return u * cosa + v * sina, v * cosa - u * sina


@pytest.mark.parametrize("alpha_deg,bound", [
    (60.0, 1e-6), (80.0, 1e-5), (89.0, 3e-4), (89.9, 3e-2)])
def test_f32_rotation_within_r11_bound(alpha_deg, bound):
    """Port and JAX package, both in f32, each against the f64 matrix
    truth within the measured R11 bound, and against each other within
    the same bound (tolerance: R11 envelope, relative to |u|+|v|)."""
    rng = np.random.default_rng(1)
    a = np.full((8, 8), np.deg2rad(alpha_deg))
    cosa32 = np.cos(a).astype(np.float32)
    sina32 = np.sin(a).astype(np.float32)
    u = (rng.standard_normal((8, 8)) * 30).astype(np.float32)
    v = (rng.standard_normal((8, 8)) * 30).astype(np.float32)
    tu, tv = trot.rotate_winds(*map(torch.from_numpy, (u, v, cosa32, sina32)))
    ju, jv = jrot.rotate_winds(*map(jnp.asarray, (u, v, cosa32, sina32)))
    assert tu.dtype == torch.float32 and ju.dtype == jnp.float32
    ut, vt = _matrix_truth(u.astype(np.float64), v.astype(np.float64),
                           np.cos(a), np.sin(a))
    scale = np.abs(u).max() + np.abs(v).max()
    for gu, gv in ((tu.numpy(), tv.numpy()), (np.asarray(ju), np.asarray(jv))):
        err = max(np.abs(gu - ut).max(), np.abs(gv - vt).max()) / scale
        assert err < bound, (alpha_deg, err, bound)
    diff = max(np.abs(tu.numpy() - np.asarray(ju)).max(),
               np.abs(tv.numpy() - np.asarray(jv)).max()) / scale
    assert diff < bound


def test_q4_sequential_3d_matches_jax_f64():
    """v is computed from the already-rotated u (quirk Q4); (ny, nx, nz)
    winds with (ny, nx) angles, f64, against the JAX package (rtol 1e-12)
    and a scalar transcription of interp.F90:737-748."""
    rng = np.random.default_rng(2)
    ny, nx, nz = 4, 5, 3
    u = rng.standard_normal((ny, nx, nz))
    v = rng.standard_normal((ny, nx, nz))
    cosa = np.cos(rng.uniform(-0.2, 0.2, (ny, nx)))
    sina = np.sin(rng.uniform(-0.2, 0.2, (ny, nx)))
    tu, tv = trot.rotate_winds(*map(torch.from_numpy, (u, v, cosa, sina)))
    ju, jv = jrot.rotate_winds(*map(jnp.asarray, (u, v, cosa, sina)))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12)
    j, i = 2, 3
    tana = sina[j, i] / cosa[j, i]
    uu = (u[j, i] + v[j, i] * tana) / (cosa[j, i] + sina[j, i] * tana)
    vv = (v[j, i] - uu * sina[j, i]) / cosa[j, i]
    np.testing.assert_allclose(tu[j, i].numpy(), uu, rtol=1e-12)
    np.testing.assert_allclose(tv[j, i].numpy(), vv, rtol=1e-12)


def test_exactly_90_degrees_is_nonfinite():
    one = torch.ones((2, 2))
    _, vr = trot.rotate_winds(one, one, torch.zeros((2, 2)), one)
    assert not torch.isfinite(vr).all()


@pytest.mark.parametrize("cosa,warns", [
    ([[1.0, 0.5], [0.05, 0.9]], True), ([[0.8, 0.8], [0.8, 0.8]], False),
    ([[0.1, 1.0], [1.0, 1.0]], False), ([[0.0999, 1.0], [1.0, 1.0]], True)])
def test_check_rotation_angles_warns_like_jax(caplog, cosa, warns):
    """Same threshold (|cosa| < 0.1), same message, same return value."""
    assert trot.COSA_WARN == jrot.COSA_WARN == 0.1
    cosa = np.asarray(cosa)
    with caplog.at_level(logging.WARNING, logger="mpassit_tpu"):
        m = trot.check_rotation_angles(cosa, name="unit test grid")
    port_msgs = [r.message for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="mpassit_tpu"):
        mj = jrot.check_rotation_angles(cosa, name="unit test grid")
    assert m == mj == pytest.approx(np.abs(cosa).min())
    assert port_msgs == [r.message for r in caplog.records]
    assert bool(port_msgs) == warns
    assert not warns or "R11" in port_msgs[0]
