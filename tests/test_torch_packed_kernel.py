"""mpassit_tpu_torch.ops.packed_kernel: the plain version against the TPU
kernel it replaces (mpassit_tpu.ops.pallas_matmul.fused_apply_packed,
ELL-direct branch, run in Pallas interpret mode on the CPU), the wrapper's
device routing and validation, the nvcc build's failure modes, and — on a
CUDA card only — the CUDA kernel against the plain version.

Tolerances: "highest"/"split6_bf16" rtol 2e-6, atol 2e-5 (R10: ~2e-7 max
rel err of either arithmetic vs f64); "split_bf16" 2.5e-5 of the largest
|out| (its R10 class); checksums rtol 1e-5 (f32 sums in another order).

The module imports JAX only inside the reference comparisons, so that the
CUDA tests also run on a card machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_packed_kernel.py
"""

import os
import stat

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.ops import packed_kernel as pk

TILE = pk.TILE


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _problem(seed, nty, ntx, W, Cp, Ks):
    rng = np.random.default_rng(seed)
    n_tiles = nty * ntx
    slab = rng.standard_normal((n_tiles, W, Cp)).astype(np.float32)
    locs, ws = [], []
    for K in Ks:
        locs.append(rng.integers(0, W, (n_tiles, K, TILE)).astype(np.int32))
        w = rng.random((n_tiles, K, TILE)).astype(np.float32)
        w *= rng.random((n_tiles, K, TILE)) < 0.8
        ws.append(w)
    alpha = rng.uniform(-0.5, 0.5, (n_tiles, 32, 32))
    return (slab, locs, ws, np.cos(alpha).astype(np.float32),
            np.sin(alpha).astype(np.float32))


def _run_both(prob, ranges, nty, ntx, rotate=(), checksum=False,
              precision="highest"):
    import jax.numpy as jnp

    from mpassit_tpu.ops.pallas_matmul import fused_apply_packed

    slab, locs, ws, cosa, sina = prob
    T = torch.from_numpy
    kw = dict(ranges=ranges, nty=nty, ntx=ntx, rotate=rotate,
              with_checksum=checksum)
    rot = dict(cosa=cosa, sina=sina) if rotate else {}
    got = pk.packed_apply_plain(T(slab), tuple(map(T, locs)),
                                tuple(map(T, ws)),
                                **kw, **{k: T(v) for k, v in rot.items()})
    ref = fused_apply_packed(
        None, jnp.asarray(slab), locs=tuple(map(jnp.asarray, locs)),
        ws=tuple(map(jnp.asarray, ws)), precision=precision,
        interpret=True, **kw, **{k: jnp.asarray(v) for k, v in rot.items()})
    return got, ref


@pytest.mark.parametrize("precision", ["highest", "split6_bf16"])
@pytest.mark.parametrize("ranges,Ks", [
    (((0, 200), (200, 230)), (3, 2)),                 # two ranges, tail zeroed
    (((0, 130), (130, 140), (140, 256)), (3, 1, 4)),  # three, no tail
])
def test_plain_matches_pallas(ranges, Ks, precision):
    nty, ntx = 2, 3
    prob = _problem(0, nty, ntx, 24, 256, Ks)
    got, ref = _run_both(prob, ranges, nty, ntx, precision=precision)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (64, 96, 256)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-5)
    tail = ranges[-1][1]
    assert (got[:, :, tail:] == 0).all()


def test_plain_matches_pallas_split_bf16():
    """split_bf16 carries ~2.5e-5 max rel error against exact arithmetic
    (R10); the port computes in f32, so the two agree to that class."""
    nty, ntx, ranges = 2, 3, ((0, 200), (200, 230))
    prob = _problem(1, nty, ntx, 24, 256, (3, 2))
    got, ref = _run_both(prob, ranges, nty, ntx, precision="split_bf16")
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < 2.5e-5, err


@pytest.mark.parametrize("rotate", [((0, 4, 4),), ((0, 50, 50), (210, 215, 5))])
def test_plain_rotation_and_checksum_match_pallas(rotate):
    """Q4 rotation windows inside the kernel, with the per-tile checksum of
    sum(out**2) over every written value."""
    nty, ntx, ranges = 2, 3, ((0, 200), (200, 230))
    prob = _problem(2, nty, ntx, 24, 256, (3, 2))
    (got, gcs), (ref, rcs) = _run_both(prob, ranges, nty, ntx,
                                       rotate=rotate, checksum=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-5)
    assert gcs.shape == (nty, ntx) and gcs.dtype == torch.float32
    np.testing.assert_allclose(gcs.numpy(), np.asarray(rcs), rtol=1e-5)
    o = got.double().numpy()
    own = np.array([[(o[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32] ** 2).sum()
                     for j in range(ntx)] for i in range(nty)])
    np.testing.assert_allclose(gcs.numpy(), own, rtol=1e-6)
    # the un-rotated output differs only on the window columns
    base = pk.packed_apply_plain(
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else
          tuple(map(torch.from_numpy, a)) for a in prob[:3]],
        ranges=ranges, nty=nty, ntx=ntx)
    touched = np.zeros(256, bool)
    for cu, cv, n in rotate:
        touched[cu:cu + n] = touched[cv:cv + n] = True
    assert torch.equal(base[:, :, ~touched], got[:, :, ~touched])


def test_cpu_tensor_runs_plain_and_counts():
    prob = _problem(3, 1, 2, 8, 128, (1,))
    T = torch.from_numpy
    launches, plain = pk.LAUNCHES, pk.PLAIN_CALLS
    out = pk.packed_apply(T(prob[0]), (T(prob[1][0]),), (T(prob[2][0]),),
                          ranges=((0, 100),), nty=1, ntx=2)
    assert out.device.type == "cpu" and out.shape == (32, 64, 128)
    assert pk.LAUNCHES == launches and pk.PLAIN_CALLS == plain + 1


def test_other_device_raises():
    slab = torch.zeros((1, 8, 128), device="meta")
    loc = torch.zeros((1, 1, TILE), dtype=torch.int32, device="meta")
    w = torch.zeros((1, 1, TILE), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.packed_apply(slab, (loc,), (w,), ranges=((0, 128),), nty=1, ntx=1)


@pytest.mark.parametrize("kw,match", [
    (dict(ranges=((0, 50), (60, 100))), "contiguously"),
    (dict(ranges=((0, 200),)), "exceeds"),
    (dict(ranges=((0, 100),), nty=2), "tiles"),
    (dict(ranges=((0, 100),), rotate=((0, 4, 4),)), "cosa"),
    (dict(ranges=((0, 100),), rotate=((90, 96, 8),)), "rotate window"),
])
def test_validation(kw, match):
    slab = torch.zeros((1, 8, 128))
    loc = torch.zeros((1, 1, TILE), dtype=torch.int32)
    w = torch.zeros((1, 1, TILE))
    args = dict(nty=1, ntx=1)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        pk.packed_apply(slab, (loc,), (w,), **args)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(pk, "_lib", None)
    monkeypatch.setattr(pk, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pk.build()


def test_failed_nvcc_build_raises(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(pk, "_lib", None)
    monkeypatch.setattr(pk, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep
                       + os.environ.get("PATH", ""))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        pk.build()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


@pytest.mark.cuda
@pytest.mark.parametrize("checksum", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, checksum):
    """On the card: the kernel rounds like the plain version (no FMA
    contraction, IEEE divisions), so outputs agree to rtol 1e-6 of
    max|plain| (bit-equal in practice); checksums rtol 1e-5."""
    nty, ntx = 3, 5
    ranges = ((0, 200), (200, 290), (290, 301))
    rotate = ((0, 50, 50), (210, 220, 10))
    slab, locs, ws, cosa, sina = _problem(4, nty, ntx, 40, 384, (3, 1, 6))
    T = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    args = (T(slab), tuple(map(T, locs)), tuple(map(T, ws)))
    kw = dict(ranges=ranges, nty=nty, ntx=ntx, rotate=rotate, cosa=T(cosa),
              sina=T(sina), with_checksum=checksum)
    launches = pk.LAUNCHES
    got = pk.packed_apply(*args, **kw)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == launches + 1
    ref = pk.packed_apply_plain(*args, **kw)
    if checksum:
        (got, gcs), (ref, rcs) = got, ref
        torch.testing.assert_close(gcs, rcs, rtol=1e-5, atol=0)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
