"""mpassit_tpu_torch.ops.onehot_kernel and the port's _build_A_T against
the JAX package: the one-hot operator and the bf16 split helpers bit for
bit; ``onehot_apply_plain`` against ``fused_apply(_prep_A(A))`` and
``onehot_apply_packed_plain`` against ``fused_apply_packed(As=...)`` (Pallas
interpret mode on the CPU) for each precision; the wrapper's routing and
validation; and — on a CUDA card only — the kernel against its plain
version.

Tolerances: the plain product and the TPU kernel form the same bf16 (or
f32) terms and differ only in the order of the f32 sums, so rtol 1e-6,
atol 1e-7 (``tests/test_pallas_matmul.py``'s own bound between two
orderings of the stacked product); the rotated columns rtol 1e-6, atol
1e-6 (the Q4 division by cosa magnifies the sum's rounding); checksums
rtol 1e-5 (f32 sums in another order).

The module imports JAX only inside the reference comparisons, so that the
CUDA tests also run on a card machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_onehot_kernel.py
"""

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.ops import onehot_kernel as ok

TILE = 1024
PRECISIONS = ("highest", "split_bf16", "split6_bf16")


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


def _rand_problem(seed, nty=2, ntx=3, W=16, Cp=512, nm=1):
    """tests/test_pallas_matmul.py::_rand_problem: one-hot-ish
    non-negative A (rows sum <= 1 in expectation), standard-normal slab."""
    rng = np.random.default_rng(seed)
    n_tiles = nty * ntx
    As = []
    for _ in range(nm):
        A = rng.random((n_tiles, W, TILE)).astype(np.float32)
        A *= rng.random((n_tiles, W, TILE)) < 3.0 / W
        As.append(A)
    slab = rng.standard_normal((n_tiles, W, Cp)).astype(np.float32)
    alpha = rng.uniform(-0.5, 0.5, (n_tiles, 32, 32))
    return (As, slab, np.cos(alpha).astype(np.float32),
            np.sin(alpha).astype(np.float32))


def _jax_prep(A, precision):
    import jax.numpy as jnp

    from mpassit_tpu.ops.matmul_apply import _prep_A

    return _prep_A(jnp.asarray(A), precision, jnp.float32)


@pytest.mark.parametrize("seed,K", [(0, 3), (1, 4), (2, 1)])
def test_build_A_T_equals_jax_bit_for_bit(seed, K):
    """Random loc/w with duplicate locs within a point and w=0 pads."""
    import jax.numpy as jnp

    from mpassit_tpu.ops.matmul_apply import _build_A_T

    rng = np.random.default_rng(seed)
    n_tiles, W = 3, 24
    T = n_tiles * TILE
    loc = rng.integers(0, W, (T, K)).astype(np.int32)
    loc[: T // 4, -1] = loc[: T // 4, 0]            # duplicate locs
    w = rng.random((T, K)).astype(np.float32)
    w[rng.random((T, K)) < 0.2] = 0.0
    ref = np.asarray(_build_A_T(jnp.asarray(loc), jnp.asarray(w),
                                n_tiles=n_tiles, w_width=W))
    got = tm._build_A_T(torch.from_numpy(loc.astype(np.uint8)),
                        torch.from_numpy(w), n_tiles, W)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.numpy().tobytes() == ref.astype(np.float32).tobytes()


def test_split_helpers_equal_jax_bit_for_bit():
    import jax.numpy as jnp

    from mpassit_tpu.ops import matmul_apply as jm

    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(4000),
        rng.random(1000) * 1e-3,                 # small weights
        np.array([0.0, -0.0, 1.0, 0.1, 1 / 3, 2.0 ** -20, 65504.0]),
    ]).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)

    def same(a, b):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(b.astype(jnp.float32)))

    for a, b in zip(ok._split_hilo(xt), jm._split_hilo(xj)):
        same(a, b)
    for a, b in zip(ok._split_3way(xt), jm._split_3way(xj)):
        same(a, b)
    x2 = xt.reshape(-1, 1)[:4000].reshape(40, 100)
    for f in ("_stack_A", "_stack_S", "_stack_A6", "_stack_S6"):
        same(getattr(ok, f)(x2, 1), getattr(jm, f)(jnp.asarray(x2.numpy()), 1))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_plain_matches_fused_apply(precision):
    """The inputs of tests/test_pallas_matmul.py:27-65."""
    from mpassit_tpu.ops.pallas_matmul import fused_apply

    (A,), slab, _, _ = _rand_problem(12345)
    ref = np.asarray(fused_apply(_jax_prep(A, precision), slab, nty=2,
                                 ntx=3, precision=precision, interpret=True))
    got = ok.onehot_apply_plain(torch.from_numpy(A), torch.from_numpy(slab),
                                nty=2, ntx=3, precision=precision)
    assert got.shape == ref.shape == (64, 96, 512)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("ranges,rotate,checksum", [
    (((0, 200), (200, 230)), (), False),                # two ranges, tail
    (((0, 130), (130, 140), (140, 256)), (), True),     # three, no tail
    (((0, 200), (200, 230)), ((0, 50, 50), (210, 215, 5)), True),
])
def test_packed_plain_matches_fused_apply_packed(precision, ranges, rotate,
                                                 checksum):
    import jax.numpy as jnp

    from mpassit_tpu.ops.pallas_matmul import fused_apply_packed

    nty, ntx = 2, 3
    As, slab, cosa, sina = _rand_problem(7, nty, ntx, W=24, Cp=256,
                                         nm=len(ranges))
    kw = dict(ranges=ranges, nty=nty, ntx=ntx, rotate=rotate,
              with_checksum=checksum, precision=precision)
    rot = dict(cosa=cosa, sina=sina) if rotate else {}
    ref = fused_apply_packed(
        tuple(_jax_prep(A, precision) for A in As), jnp.asarray(slab),
        interpret=True, **kw, **{k: jnp.asarray(v) for k, v in rot.items()})
    got = ok.onehot_apply_packed_plain(
        tuple(map(torch.from_numpy, As)), torch.from_numpy(slab), **kw,
        **{k: torch.from_numpy(v) for k, v in rot.items()})
    if checksum:
        (got, gcs), (ref, rcs) = got, ref
        assert gcs.shape == (nty, ntx) and gcs.dtype == torch.float32
        np.testing.assert_allclose(gcs.numpy(), np.asarray(rcs), rtol=1e-5)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (64, 96, 256)
    touched = np.zeros(256, bool)
    for cu, cv, n in rotate:
        touched[cu:cu + n] = touched[cv:cv + n] = True
    np.testing.assert_allclose(got.numpy()[:, :, ~touched],
                               ref[:, :, ~touched], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.numpy()[:, :, touched],
                               ref[:, :, touched], rtol=1e-6, atol=1e-6)
    assert (got[:, :, ranges[-1][1]:] == 0).all()


def test_split_terms_are_compensated():
    """split6_bf16 lands in the f32 class against float64 truth, split_bf16
    in its ~1e-5 class: the residuals survive the port's splits."""
    (A,), slab, _, _ = _rand_problem(5, W=8, Cp=256)
    truth = np.einsum("twp,twc->tpc", A.astype(np.float64),
                      slab.astype(np.float64))
    truth = truth.reshape(2, 3, 32, 32, 256).transpose(0, 2, 1, 3, 4)
    truth = truth.reshape(64, 96, 256)
    scale = np.abs(slab).max()
    errs = {}
    for precision in PRECISIONS:
        got = ok.onehot_apply_plain(torch.from_numpy(A),
                                    torch.from_numpy(slab), nty=2, ntx=3,
                                    precision=precision)
        errs[precision] = np.abs(got.double().numpy() - truth).max() / scale
    assert errs["highest"] < 1e-6 and errs["split6_bf16"] < 1e-6, errs
    assert 1e-7 < errs["split_bf16"] < 2e-4, errs


def test_cpu_tensor_runs_plain_and_counts():
    (A,), slab, _, _ = _rand_problem(3, nty=1, ntx=2, W=8, Cp=128)
    A, slab = torch.from_numpy(A), torch.from_numpy(slab)
    launches, plain = dict(ok.LAUNCHES), dict(ok.PLAIN_CALLS)
    out = ok.onehot_apply(A, slab, nty=1, ntx=2, precision="split6_bf16")
    assert out.device.type == "cpu" and out.shape == (32, 64, 128)
    ok.onehot_apply_packed((A,), slab, ranges=((0, 100),), nty=1, ntx=2)
    assert ok.LAUNCHES == launches
    assert ok.PLAIN_CALLS == {k: v + 1 for k, v in plain.items()}


def test_other_device_raises():
    A = torch.zeros((1, 8, TILE), device="meta")
    slab = torch.zeros((1, 8, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ok.onehot_apply(A, slab, nty=1, ntx=1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ok.onehot_apply_packed((A,), slab, ranges=((0, 128),), nty=1, ntx=1)


@pytest.mark.parametrize("kw,match", [
    (dict(precision="bf16"), "precision"),
    (dict(A=torch.zeros((1, 16, TILE))), "A must be"),
    (dict(A=torch.zeros((1, 8, TILE), dtype=torch.bfloat16)), "A must be"),
    (dict(ranges=((0, 50), (60, 100))), "contiguously"),
    (dict(ranges=((0, 100), (100, 120)), As=1), "one A per range"),
    (dict(ranges=((0, 100),), rotate=((0, 4, 4),)), "cosa"),
    (dict(ranges=((0, 100),), rotate=((90, 96, 8),)), "rotate window"),
])
def test_validation(kw, match):
    A = kw.pop("A", torch.zeros((1, 8, TILE)))
    slab = torch.zeros((1, 8, 128))
    args = dict(nty=1, ntx=1, ranges=((0, 128),))
    args.update(kw)
    As = (A,) * args.pop("As", 1)
    with pytest.raises(ValueError, match=match):
        ok.onehot_apply_packed(As, slab, **args)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("checksum", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, precision, checksum):
    """On the card: the kernel against its plain version, rtol 1e-6 of
    max|plain| (same terms, another order of the f32 sums); checksums rtol
    1e-5. Three methods, a tail, two rotation windows (one pairing across
    a 128-column block), W not a multiple of the kernel's 32-row step."""
    nty, ntx = 3, 5
    ranges = ((0, 200), (200, 290), (290, 301))
    rotate = ((0, 50, 50), (210, 220, 10))
    As, slab, cosa, sina = _rand_problem(4, nty, ntx, W=40, Cp=384, nm=3)
    T = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    kw = dict(ranges=ranges, nty=nty, ntx=ntx, rotate=rotate, cosa=T(cosa),
              sina=T(sina), with_checksum=checksum, precision=precision)
    args = (tuple(map(T, As)), T(slab))
    launches = ok.LAUNCHES["onehot_apply_packed"]
    got = ok.onehot_apply_packed(*args, **kw)
    torch.cuda.synchronize()
    assert ok.LAUNCHES["onehot_apply_packed"] == launches + 1
    ref = ok.onehot_apply_packed_plain(*args, **kw)
    if checksum:
        (got, gcs), (ref, rcs) = got, ref
        torch.testing.assert_close(gcs, rcs, rtol=1e-5, atol=0)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    # the single-method entry point
    A0, s0 = args[0][0], args[1]
    one = ok.onehot_apply(A0, s0, nty=nty, ntx=ntx, precision=precision)
    ref1 = ok.onehot_apply_plain(A0, s0, nty=nty, ntx=ntx,
                                 precision=precision)
    assert (one - ref1).abs().max() <= 1e-6 * ref1.abs().max()
