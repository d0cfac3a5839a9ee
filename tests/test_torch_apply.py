"""mpassit_tpu_torch.ops.apply against mpassit_tpu.ops.apply on the inputs
of tests/test_apply.py. Tolerances: f64 rtol 1e-12 (same arithmetic, sum
order may differ); f32 rtol 2e-6, atol 2e-5 (R10 'highest' class)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpassit_tpu.ops import apply as japply
from mpassit_tpu.weights.bilinear import bilinear_cell_weights
from mpassit_tpu.weights.ell import ELLWeights
from mpassit_tpu.weights.nearest import nearest_weights
from mpassit_tpu_torch.ops.apply import Regridder, apply_ell

from test_weights import coarse_lambert_grid

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bilinear(small_mesh):
    grid = coarse_lambert_grid(nx=16, ny=12)
    return bilinear_cell_weights(small_mesh, grid.lat, grid.lon)


def test_f64_matches_jax_and_oracle(small_mesh, bilinear):
    ell = bilinear
    src = np.random.default_rng(0).standard_normal((small_mesh.ncells, 7))
    got = Regridder(ell, CPU, dtype=torch.float64).apply_np(src)
    ref = japply.Regridder(ell, dtype=jnp.float64).apply_np(src)
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    oracle = (ell.w[:, :, None] * src[ell.idx]).sum(axis=1)
    np.testing.assert_allclose(got.reshape(-1, 7), oracle, rtol=1e-12)
    got1 = Regridder(ell, CPU, dtype=torch.float64).apply_np(src[:, 0])
    np.testing.assert_allclose(got1, ref[..., 0], rtol=1e-12)


def test_f32_matches_jax(small_mesh, bilinear):
    ell = bilinear
    src = (np.random.default_rng(1).standard_normal((small_mesh.ncells, 3))
           * 100.0).astype(np.float32)
    got = Regridder(ell, CPU, dtype=torch.float32).apply_np(src)
    ref = japply.Regridder(ell, dtype=jnp.float32).apply_np(src)
    assert got.dtype == np.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float64, jnp.float64, dict(rtol=1e-12)),
    (torch.float32, jnp.float32, dict(rtol=2e-6, atol=2e-5))])
def test_apply_ell_matches_jax(small_mesh, bilinear, dtype, jdtype, tol):
    ell = bilinear
    npd = np.float64 if dtype == torch.float64 else np.float32
    src = np.random.default_rng(2).standard_normal(
        (small_mesh.ncells, 4)).astype(npd)
    got = apply_ell(torch.as_tensor(np.asarray(ell.idx, np.int64)),
                    torch.as_tensor(np.asarray(ell.w), dtype=dtype),
                    torch.from_numpy(src))
    ref = japply.apply_ell(jnp.asarray(ell.idx, jnp.int32),
                           jnp.asarray(ell.w, jdtype), jnp.asarray(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


def test_column_chunking(small_mesh):
    grid = coarse_lambert_grid(nx=8, ny=6)
    ell = nearest_weights(small_mesh, grid.lat, grid.lon)
    src = np.arange(small_mesh.ncells * 70, dtype=np.float64).reshape(
        small_mesh.ncells, 70)
    small = Regridder(ell, CPU, dtype=torch.float64, max_cols=16)
    big = Regridder(ell, CPU, dtype=torch.float64, max_cols=1024)
    np.testing.assert_array_equal(small.apply_np(src), big.apply_np(src))
    np.testing.assert_array_equal(
        big.apply_np(src), japply.Regridder(ell, dtype=jnp.float64,
                                            max_cols=16).apply_np(src))


def test_unmapped_rows_stay_zero():
    """Quirk Q5: unmapped targets keep the zero-initialized destination."""
    idx = np.array([[1, 2, 3], [0, 0, 0]], dtype=np.int32)
    w = np.array([[0.2, 0.3, 0.5], [0.0, 0.0, 0.0]])
    ell = ELLWeights(idx=idx, w=w, n_src=5, method="bilinear", dst_shape=(2,))
    out = Regridder(ell, CPU, dtype=torch.float64).apply_np(np.arange(5.0))
    assert out[1] == 0.0
    np.testing.assert_allclose(out[0], 0.2 * 1 + 0.3 * 2 + 0.5 * 3)


def test_wrong_source_rows_raise(bilinear):
    rg = Regridder(bilinear, CPU)
    with pytest.raises(ValueError, match="rows"):
        rg.apply_np(np.zeros((bilinear.n_src + 1, 2), np.float32))
