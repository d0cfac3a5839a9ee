"""mpassit_tpu_torch.ops.gather_kernel and the port's _chunk_slab against
the JAX package: the chunked-run layout byte for byte (and the slab it
reproduces), ``packed_gather_apply_plain`` against
``fused_apply_packed_gather`` (Pallas interpret mode on the CPU) and,
bit for bit, against ``packed_apply_plain`` on the ``index_select`` slab;
the wrapper's routing and validation; and — on a CUDA card only — the
kernel against its plain version and against the packed_apply kernel.

Tolerances: against the TPU kernel rtol 1e-5, atol 1e-6
(tests/test_pallas_matmul.py:227, the JAX package's own bound between its
gather and take routes; "split_bf16" runs bf16 terms there, f32 here, so
that case is held to its R10 class, 2.5e-5 of max|out|); checksums rtol
1e-5; inside the port, bit for bit.

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_gather_kernel.py
"""

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.ops import gather_kernel as gk
from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.ops import packed_kernel as pk

TILE = 1024
CH = tm.CH


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


def _random_ell(seed, ny=40, nx=70, n_src=500, K=3, p_zero=0.15):
    rng = np.random.default_rng(seed)
    T = ny * nx
    idx = np.sort(rng.integers(0, n_src, (T, K)).astype(np.int64), axis=1)
    w = rng.random((T, K))
    w[rng.random((T, K)) < p_zero] = 0.0
    return idx, w


def _coherent_ell():
    """tests/test_chunk_slab.py: Morton-like runs crossing CH boundaries."""
    rng = np.random.default_rng(7)
    ny, nx, K, n_src = 64, 64, 4, 5000
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    base = ((jj // 4) * (nx // 4) + ii // 4).reshape(-1) * 3 % (n_src - K - 8)
    idx = base[:, None] + np.arange(K)[None, :]
    w = rng.random((ny * nx, K))
    w[rng.random((ny * nx, K)) < 0.1] = 0.0
    return idx.astype(np.int64), w, ny, nx, n_src


def _row_zero_ell():
    """tests/test_chunk_slab.py: row 0 with real weight, unmapped tiles."""
    ny, nx, K, n_src = 33, 34, 3, 100
    idx = np.zeros((ny * nx, K), np.int64)
    w = np.zeros((ny * nx, K))
    w[: ny * nx // 2, 0] = 1.0
    return idx, w, ny, nx, n_src


CASES = ([(*_random_ell(s, p_zero=0.2, n_src=n), 40, 70, n)
          for s, n in [(0, 3000), (1, 400), (2, 37), (3, 1900)]]
         + [_coherent_ell(), _row_zero_ell()])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_chunk_slab_equals_jax_byte_for_byte(case):
    from mpassit_tpu.ops.matmul_apply import _pack_compact, _pack_union

    idx, w, ny, nx, n_src = CASES[case]
    ref = _pack_compact(_pack_union(idx, w, ny, nx, n_src))
    slab_idx, loc, loc_w, W, _, _, n_tiles = tm._pack_compact(
        tm._pack_union(idx, w, ny, nx, n_src))
    ch_src, loc8, W8 = tm._chunk_slab(slab_idx, loc, loc_w, W)
    for a, b in ((ch_src, ref[9]), (loc8, ref[10])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert W8 == ref[11] == ch_src.shape[1] * CH
    # the emulation invariant of tests/test_chunk_slab.py: every
    # nonzero-weight entry's chunk-layout row is the slab row it had
    K = idx.shape[1]
    src_pad = np.pad(np.arange(n_src, dtype=np.float64), (0, CH))
    rows8 = (ch_src.astype(np.int64)[:, :, None] * CH
             + np.arange(CH)).reshape(n_tiles, W8)
    val = loc_w.reshape(n_tiles, TILE * K) != 0
    lold = loc.reshape(n_tiles, TILE * K).astype(np.int64)
    l8 = loc8.reshape(n_tiles, TILE * K).astype(np.int64)
    for t in range(n_tiles):
        np.testing.assert_array_equal(
            src_pad[rows8[t][l8[t][val[t]]]],
            slab_idx[t][lold[t][val[t]]])


def _gather_problem(seed, Ks=(3,), Cp=128, ny=40, nx=70, n_src=500,
                    coherent=False):
    """Per-method ELLs over one source space, packed as the regridders
    pack them: host layout and the kernels' device layout. ``coherent``
    gives each 4x4 block of targets neighbouring source rows, as a
    Morton-ordered mesh does (few chunks per tile: Pallas interpret mode
    pays per chunk copy)."""
    rng = np.random.default_rng(seed)
    ells = [_random_ell(seed + m, ny, nx, n_src, K) for m, K in enumerate(Ks)]
    idx = np.concatenate([e[0] for e in ells], axis=1)
    w = np.concatenate([e[1] for e in ells], axis=1)
    if coherent:
        jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        base = ((jj // 4) * (nx // 4) + ii // 4).reshape(-1) % (n_src - 8)
        idx = base[:, None] + rng.integers(0, 8, idx.shape)
    slab_idx, loc, loc_w, W, nty, ntx, n_tiles = tm._pack_compact(
        tm._pack_union(idx, w, ny, nx, n_src))
    ch_src, loc8, W8 = tm._chunk_slab(slab_idx, loc, loc_w, W)
    src = rng.standard_normal((n_src, Cp)).astype(np.float32)
    alpha = rng.uniform(-0.5, 0.5, (n_tiles, 32, 32))

    def per(a, dt):
        return tuple(t.numpy() for t in
                     tm._per_method(a, n_tiles, Ks, dt, "cpu"))
    return dict(src=src, src_pad=np.pad(src, ((0, CH), (0, 0))),
                slab_idx=slab_idx, ch_src=ch_src.astype(np.int32), W8=W8,
                locs=per(loc, np.int32), locs8=per(loc8, np.int32),
                ws=per(loc_w, np.float32), nty=nty, ntx=ntx,
                cosa=np.cos(alpha).astype(np.float32),
                sina=np.sin(alpha).astype(np.float32))


@pytest.mark.parametrize("precision", ["highest", "split_bf16"])
@pytest.mark.parametrize("Ks,ranges,rotate,checksum", [
    ((3,), ((0, 128),), (), False),                  # test_pallas_matmul:187
    ((3, 1), ((0, 100), (100, 113)), ((0, 40, 40),), True),
])
def test_plain_matches_fused_apply_packed_gather(precision, Ks, ranges,
                                                 rotate, checksum):
    import jax.numpy as jnp

    from mpassit_tpu.ops.pallas_matmul import fused_apply_packed_gather

    P = _gather_problem(11, Ks, coherent=True)
    J, T = jnp.asarray, torch.from_numpy
    kw = dict(W8=P["W8"], ranges=ranges, nty=P["nty"], ntx=P["ntx"],
              rotate=rotate, with_checksum=checksum)
    rot = ("cosa", "sina") if rotate else ()
    ref = fused_apply_packed_gather(
        J(P["src_pad"]), J(P["ch_src"]), tuple(map(J, P["locs8"])),
        tuple(map(J, P["ws"])), precision=precision, interpret=True, **kw,
        **{k: J(P[k]) for k in rot})
    got = gk.packed_gather_apply_plain(
        T(P["src_pad"]), T(P["ch_src"]), tuple(map(T, P["locs8"])),
        tuple(map(T, P["ws"])), **kw, **{k: T(P[k]) for k in rot})
    if checksum:
        (got, gcs), (ref, rcs) = got, ref
        np.testing.assert_allclose(gcs.numpy(), np.asarray(rcs), rtol=1e-5)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if precision == "highest":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    else:
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err < 2.5e-5, err
    assert (got[:, :, ranges[-1][1]:] == 0).all()


@pytest.mark.parametrize("rotate,checksum", [((), False),
                                             (((0, 40, 40),), True)])
def test_plain_equals_packed_apply_plain_bit_for_bit(rotate, checksum):
    P = _gather_problem(12, (3, 1, 2), Cp=256, n_src=900)
    T = torch.from_numpy
    ranges = ((0, 150), (150, 170), (170, 200))
    kw = dict(ranges=ranges, nty=P["nty"], ntx=P["ntx"], rotate=rotate,
              with_checksum=checksum)
    if rotate:
        kw.update(cosa=T(P["cosa"]), sina=T(P["sina"]))
    slab = torch.index_select(T(P["src"]), 0,
                              T(P["slab_idx"].reshape(-1))).view(
        len(P["slab_idx"]), -1, 256)
    ref = pk.packed_apply_plain(slab, tuple(map(T, P["locs"])),
                                tuple(map(T, P["ws"])), **kw)
    got = gk.packed_gather_apply_plain(
        T(P["src_pad"]), T(P["ch_src"]), tuple(map(T, P["locs8"])),
        tuple(map(T, P["ws"])), W8=P["W8"], **kw)
    for a, b in zip(got if checksum else (got,), ref if checksum else (ref,)):
        assert torch.equal(a, b)


def test_cpu_tensor_runs_plain_and_counts():
    P = _gather_problem(13)
    T = torch.from_numpy
    launches, plain = gk.LAUNCHES, gk.PLAIN_CALLS
    out = gk.packed_gather_apply(
        T(P["src_pad"]), T(P["ch_src"]), tuple(map(T, P["locs8"])),
        tuple(map(T, P["ws"])), W8=P["W8"], ranges=((0, 100),),
        nty=P["nty"], ntx=P["ntx"])
    assert out.device.type == "cpu"
    assert out.shape == (P["nty"] * 32, P["ntx"] * 32, 128)
    assert gk.LAUNCHES == launches and gk.PLAIN_CALLS == plain + 1


@pytest.mark.parametrize("kw,match", [
    (dict(W8=16), "W8"),
    (dict(ch_src=torch.zeros((1, 1), dtype=torch.int64)), "ch_src"),
    (dict(src=torch.zeros((16, 128), dtype=torch.float64)), "src"),
    (dict(ranges=((0, 200),)), "exceeds"),
    (dict(ranges=((0, 100),), rotate=((0, 4, 4),)), "cosa"),
    (dict(ranges=((0, 100),), nty=2), "tiles"),
])
def test_validation(kw, match):
    args = dict(src=torch.zeros((16, 128)),
                ch_src=torch.zeros((1, 1), dtype=torch.int32),
                W8=8, ranges=((0, 128),), nty=1, ntx=1)
    args.update(kw)
    loc = torch.zeros((1, 1, TILE), dtype=torch.int32)
    w = torch.zeros((1, 1, TILE))
    src, ch = args.pop("src"), args.pop("ch_src")
    with pytest.raises(ValueError, match=match):
        gk.packed_gather_apply(src, ch, (loc,), (w,), **args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gk.packed_gather_apply(
            torch.zeros((16, 128), device="meta"),
            torch.zeros((1, 1), dtype=torch.int32, device="meta"),
            (loc.to("meta"),), (w.to("meta"),), W8=8, ranges=((0, 128),),
            nty=1, ntx=1)


@pytest.mark.cuda
@pytest.mark.parametrize("checksum", [False, True])
def test_cuda_kernel_matches_plain_and_packed_apply(cuda_device, checksum):
    """On the card: the kernel against its plain version (rtol 1e-6 of
    max|plain|, bit-equal in practice; checksums rtol 1e-5) and, bit for
    bit, against the packed_apply kernel on the index_select slab."""
    from mpassit_tpu_torch.ops import packed_kernel as pk

    P = _gather_problem(14, (3, 1, 2), Cp=384, n_src=900)
    T = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    ranges = ((0, 200), (200, 290), (290, 301))
    kw = dict(ranges=ranges, nty=P["nty"], ntx=P["ntx"],
              rotate=((0, 50, 50), (210, 220, 10)), cosa=T(P["cosa"]),
              sina=T(P["sina"]), with_checksum=checksum)
    args = (T(P["src_pad"]), T(P["ch_src"]), tuple(map(T, P["locs8"])),
            tuple(map(T, P["ws"])))
    launches = gk.LAUNCHES
    got = gk.packed_gather_apply(*args, W8=P["W8"], **kw)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == launches + 1
    ref = gk.packed_gather_apply_plain(*args, W8=P["W8"], **kw)
    slab = torch.index_select(T(P["src"]), 0,
                              T(P["slab_idx"].reshape(-1))).view(
        len(P["slab_idx"]), -1, 384)
    k1 = pk.packed_apply(slab, tuple(map(T, P["locs"])), args[3], **kw)
    if checksum:
        (got, gcs), (ref, rcs), (k1, kcs) = got, ref, k1
        torch.testing.assert_close(gcs, rcs, rtol=1e-5, atol=0)
        assert torch.equal(gcs, kcs)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    assert torch.equal(got, k1)


@pytest.mark.parametrize("module", ["gather_kernel", "onehot_kernel"])
def test_failed_build_raises(tmp_path, monkeypatch, module):
    """No nvcc, or an nvcc that fails: build() raises, leaves no library
    and no half-written one, and the module stays unbuilt."""
    import importlib
    import stat

    mod = importlib.import_module(f"mpassit_tpu_torch.ops.{module}")
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mod.build()
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        mod.build()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
    assert mod._lib is None
