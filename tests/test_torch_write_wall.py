"""mpassit_tpu_torch.ops.write_wall: the plain version against the TPU
kernel it replaces (bench.make_write_wall, run in Pallas interpret mode on
the CPU), the wrapper's routing, counters and validation, and — on a CUDA
card only — the kernel against its plain version.

Tolerance: none. The output is a copy of the seed row, so the port and JAX
agree exactly; with ``n_passes=1`` the JAX function returns
``out[0, 0, 0] + out[-1, -1, -1]`` (from 0.0, in f32) of that output, and
the kernel must equal its plain version bit for bit.

The module imports JAX only inside the reference comparison, so that the
CUDA tests also run on a card machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_write_wall.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.ops import write_wall as ww

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _seed(rng, Cp):
    return rng.standard_normal((1, 1, Cp)).astype(np.float32)


@pytest.mark.parametrize("nty,ntx,Cp", [(1, 1, 128), (2, 3, 256),
                                        (3, 2, 384)])
def test_plain_matches_jax_write_wall(nty, ntx, Cp):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    sys.path.insert(0, REPO)
    from bench import make_write_wall

    seed = _seed(np.random.default_rng(nty * 10 + ntx), Cp)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(make_write_wall(1, nty, ntx, Cp)(jnp.asarray(seed)))
    got = ww.write_wall_plain(torch.from_numpy(seed), nty=nty, ntx=ntx)
    assert got.shape == (nty * 32, ntx * 32, Cp)
    assert got.dtype == torch.float32
    corners = np.float32(0.0) + got[0, 0, 0].numpy() + got[-1, -1, -1].numpy()
    assert ref.dtype == np.float32 and corners.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(seed, (nty * 32, ntx * 32, Cp)))


def test_plain_output_is_its_own_storage():
    """The plain version returns a written array, not a broadcast view."""
    seed = torch.ones((1, 1, 8))
    out = ww.write_wall_plain(seed, nty=1, ntx=1)
    assert out.is_contiguous() and out.stride() == (32 * 8, 8, 1)
    out[0, 0, 0] = 5.0
    assert out[1, 1, 0] == 1.0 and seed[0, 0, 0] == 1.0


def test_cpu_tensor_runs_plain_and_counts():
    seed = torch.from_numpy(_seed(np.random.default_rng(1), 128))
    launches, plain = ww.LAUNCHES, ww.PLAIN_CALLS
    out = ww.write_wall(seed, nty=1, ntx=2)
    assert out.device.type == "cpu" and out.shape == (32, 64, 128)
    assert torch.equal(out, seed.expand(32, 64, 128))
    assert ww.LAUNCHES == launches and ww.PLAIN_CALLS == plain + 1


def test_other_device_raises():
    with pytest.raises(ValueError, match="cuda or cpu"):
        ww.write_wall(torch.zeros((1, 1, 128), device="meta"), nty=1, ntx=1)


@pytest.mark.parametrize("seed,kw,match", [
    (torch.zeros(128), {}, "seed must be"),
    (torch.zeros((1, 2, 128)), {}, "seed must be"),
    (torch.zeros((1, 1, 128), dtype=torch.float64), {}, "seed must be"),
    (torch.zeros((1, 1, 6)), {}, "multiple of 4"),
    (torch.zeros((1, 1, 128)), dict(nty=0), "at least"),
])
def test_validation(seed, kw, match):
    args = dict(nty=1, ntx=1)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ww.write_wall(seed, **args)


@pytest.mark.cuda
@pytest.mark.parametrize("nty,ntx,Cp", [
    (1, 1, 4),           # one float4 per row
    (2, 3, 12),          # 3 float4 per row: rows per block do not divide
    (3, 5, 128),
    (2, 2, 1024),        # the packed CONUS width
    (1, 2, 2048),        # more float4 per row than threads per block
])
def test_cuda_kernel_matches_plain(cuda_device, nty, ntx, Cp):
    seed = torch.from_numpy(_seed(np.random.default_rng(Cp), Cp)).to(
        cuda_device)
    launches = ww.LAUNCHES
    got = ww.write_wall(seed, nty=nty, ntx=ntx)
    torch.cuda.synchronize()
    assert ww.LAUNCHES == launches + 1
    assert torch.equal(got, ww.write_wall_plain(seed, nty=nty, ntx=ntx))
