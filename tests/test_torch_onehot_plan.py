"""The one-hot kernel's numerics and launch plan on the CPU.

- The six-term set against f32: the card's ``onehot_apply_packed`` computes
  ``highest`` as the split6_bf16 terms (XLA's Precision.HIGHEST, bf16_6x),
  its plain version as an f32 product. ``_tile_matmul`` of the split6
  stacks agrees with the plain ``highest`` and with the JAX package's
  ``fused_apply(precision="highest")`` (Pallas interpret mode) within 1e-6
  of max|.|, on operators with duplicate locations and pads and slab
  values spread over 2^-20..2^20: the tolerance of the card's comparison.
- ``launch_plan``, the kernel's launch geometry: padded K, grid, method
  passes per 128-column chunk, where rotation partners are computed,
  checksum partials and shared memory, at the shipped shapes and at the
  edges; the ValueErrors for shapes the kernel does not take.
- The plan's table read as the kernel reads it (``_emulate``: own and
  partner tiles, method passes over zero-masked slab columns, the
  rotation roles, tail zeros, per-block checksum partials) against
  ``onehot_apply_packed_plain``: f32 sums in another order, so rtol 1e-6
  of max|plain| (rotated columns included) and checksums rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.ops import matmul_apply as tm
from mpassit_tpu_torch.ops import onehot_kernel as ok

TILE = 1024
COLS = 128


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spread_problem(seed, nty=2, ntx=2, W=24, K=4, Cp=128):
    """A from random loc/w with duplicate locs and w=0 pads
    (``_build_A_T``, the JAX order), slab values of both signs spread over
    2^-20..2^20."""
    rng = np.random.default_rng(seed)
    n_tiles = nty * ntx
    T = n_tiles * TILE
    loc = rng.integers(0, W, (T, K)).astype(np.uint8)
    loc[: T // 3, 1] = loc[: T // 3, 0]                 # duplicate locs
    w = rng.random((T, K)).astype(np.float32)
    w[rng.random((T, K)) < 0.25] = 0.0                  # pads
    A = tm._build_A_T(torch.from_numpy(loc), torch.from_numpy(w), n_tiles, W)
    mag = 2.0 ** rng.uniform(-20, 20, (n_tiles, W, Cp))
    slab = (rng.standard_normal((n_tiles, W, Cp)) * mag).astype(np.float32)
    return A, torch.from_numpy(slab)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_six_terms_match_f32_highest(seed):
    """split6 stacks (the card's highest) vs the f32 product and the TPU
    kernel's highest, within 1e-6 of the largest magnitude."""
    from mpassit_tpu.ops.pallas_matmul import fused_apply

    A, slab = _spread_problem(seed)
    six = ok._tile_matmul(ok._prep_A(A, "split6_bf16"), slab, "split6_bf16")
    f32 = ok._tile_matmul(ok._prep_A(A, "highest"), slab, "highest")
    scale = float(f32.abs().max())
    assert float((six - f32).abs().max()) <= 1e-6 * scale
    # the same in the target layout against the JAX package
    got = ok.onehot_apply_packed_plain((A,), slab, ranges=((0, 128),),
                                       nty=2, ntx=2,
                                       precision="split6_bf16").numpy()
    ref = np.asarray(fused_apply(A.numpy(), slab.numpy(), nty=2, ntx=2,
                                 precision="highest", interpret=True))
    assert got.shape == ref.shape == (64, 64, 128)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# --------------------------------------------------------- launch plan ----

SHAPES = {
    # the CONUS pack: three methods, two boundaries inside chunk 7
    "conus_pack": (1938, 40, 1024, ((0, 992), (992, 1008), (1008, 1024)),
                   ((0, 55, 55),)),
    # the EDGE1 restagger
    "edge1": (1938, 1096, 128, ((0, 128),), ()),
    "w8_tail": (6, 8, 384, ((0, 200), (200, 290), (290, 301)),
                ((0, 50, 50), (210, 220, 10))),
    "w2048": (2, 2048, 256, ((0, 256),), ()),
    # window (100, 150, 20): u in chunk 0, v in chunk 1
    "straddle": (3, 40, 384, ((0, 200), (200, 290), (290, 301)),
                 ((100, 150, 20), (210, 220, 10))),
    "tail_chunk": (2, 16, 512, ((0, 100), (100, 130)), ()),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("precision", ["split6_bf16", "split_bf16"])
def test_launch_plan_geometry(name, precision):
    n_tiles, W, Cp, ranges, rotate = SHAPES[name]
    plan = ok.launch_plan(n_tiles, W, Cp, ranges, rotate, precision)
    nchunk = Cp // COLS
    assert plan.K % ok.K_STEP == 0 and W <= plan.K < W + ok.K_STEP
    assert plan.steps == -(-plan.K // ok.KS)
    assert plan.grid == n_tiles * nchunk * ok.NSTRIP
    assert plan.n_parts == nchunk * ok.NSTRIP
    assert plan.terms == ok.TERMS[precision]
    assert 0 < plan.smem <= ok.SMEM_MAX

    def method_of(c):
        for m, (c0, c1) in enumerate(ranges):
            if c0 <= c < c1:
                return m
        return -1

    # every column computed exactly once, in its chunk's pass of its method
    table = plan.table
    for c in range(Cp):
        m = method_of(c)
        assert table[c] == m
        hits = [(j, mm) for j, ms in enumerate(plan.own) for mm in ms
                if j == c // COLS and mm == m]
        assert len(hits) == (1 if m >= 0 else 0), c
    for j, ms in enumerate(plan.own):
        assert ms == tuple(sorted({method_of(c) for c in
                                   range(j * COLS, (j + 1) * COLS)} - {-1}))
        assert table[3 * Cp + j] == sum(1 << m for m in ms)
    # rotation partners: in the chunk's own tile, or in its partner tile
    # under the partner's method
    pairs = {}
    for cu, cv, n in rotate:
        for i in range(n):
            pairs[cu + i] = (1, cv + i)
            pairs[cv + i] = (2, cu + i)
    for c in range(Cp):
        role, p = pairs.get(c, (0, -1))
        assert (table[Cp + c], table[2 * Cp + c]) == (role, p)
    for j in range(nchunk):
        ext = tuple((c, p) for c, (_, p) in sorted(pairs.items())
                    if c // COLS == j and p // COLS != j)
        assert plan.external[j] == ext
        if ext:
            assert plan.partner[j] == tuple(sorted({method_of(p)
                                                    for _, p in ext}))
        else:
            assert plan.partner[j] is None
            assert table[3 * Cp + nchunk + j] == -1
    assert plan.partnered == (name == "straddle")
    assert plan.smem == ok._smem_bytes(plan.terms, plan.partnered)


def test_launch_plan_shipped_numbers():
    """The CONUS pack: 7 one-method chunks and chunk 7 with three passes;
    the EDGE1 restagger: K = 1104 in 35 steps."""
    pack = ok.launch_plan(*SHAPES["conus_pack"])
    assert pack.own == ((0,),) * 7 + ((0, 1, 2),)
    assert pack.K == 48 and pack.steps == 2 and pack.passes == 80
    assert pack.smem == 98_304
    edge = ok.launch_plan(*SHAPES["edge1"])
    assert edge.K == 1104 and edge.steps == 35 and edge.grid == 1938 * 8
    assert edge.flop == 2 * 6 * 1938 * 1024 * 128 * 1104


@pytest.mark.parametrize("W", [1, 7, 8, 16, 17, 1096, 2047, 2048])
def test_launch_plan_takes_every_W(W):
    plan = ok.launch_plan(1, W, 128, ((0, 128),), (), "split6_bf16")
    assert plan.K == -(-W // 16) * 16 and plan.smem <= ok.SMEM_MAX


@pytest.mark.parametrize("args,match", [
    ((1, 0, 128, ((0, 128),), ()), "W=0"),
    ((1, 2049, 128, ((0, 128),), ()), "W=2049"),
    ((1, 8, 100, ((0, 100),), ()), "multiple of 128"),
    ((1, 8, 0, ((0, 1),), ()), "multiple of 128"),
    ((0, 8, 128, ((0, 128),), ()), "no tiles"),
    ((1, 8, 1152, tuple((i, i + 1) for i in range(9)), ()), "ranges"),
    ((1, 8, 128, ((0, 100), (90, 128)), ()), "contiguously"),
    ((1, 8, 128, ((0, 129),), ()), "contiguously"),
    ((1, 8, 128, ((0, 128),), ((0, 4, 4), (2, 8, 2))), "share column"),
    ((1, 8, 128, ((0, 128),), ((120, 126, 4),)), "outside"),
])
def test_launch_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        ok.launch_plan(*args)


def test_launch_plan_rejects_precision():
    with pytest.raises(ValueError, match="precision"):
        ok.launch_plan(1, 8, 128, ((0, 128),), (), "bf16")


# ------------------------------------------- the table, as the kernel ----

def _emulate(plan, As, slab, nty, ntx, cosa, sina):
    """csrc/onehot_apply.cu's algorithm on plan.table, in torch on the
    CPU with f32 products: per chunk the own tile (one pass per method of
    its mask, the slab columns of other methods zero), the partner tile,
    the epilogue's rotation roles and tail zeros, and the checksum as
    per-(chunk, strip) partials added in order."""
    n_tiles, W, Cp = slab.shape
    nchunk = plan.nchunk
    tab = torch.tensor(plan.table)
    meth, role, part = tab[:Cp], tab[Cp:2 * Cp], tab[2 * Cp:3 * Cp]
    own, pm = tab[3 * Cp:3 * Cp + nchunk], tab[3 * Cp + nchunk:]

    def tile(mask, cols):
        acc = torch.zeros((n_tiles, TILE, COLS))
        for m in range(len(As)):
            if not (int(mask) >> m) & 1:
                continue
            valid = (cols >= 0) & (meth[cols.clamp_min(0)] == m)
            s = slab[:, :, cols.clamp_min(0)] * valid
            acc += torch.bmm(As[m].transpose(1, 2), s)
        return acc

    blocks = torch.zeros((n_tiles, TILE, Cp))
    partial = torch.zeros((n_tiles, nchunk, ok.NSTRIP), dtype=torch.float64)
    ca = cosa.reshape(n_tiles, TILE, 1) if cosa is not None else None
    sa = sina.reshape(n_tiles, TILE, 1) if sina is not None else None
    for j in range(nchunk):
        c = torch.arange(j * COLS, (j + 1) * COLS)
        e1 = tile(own[j], c)
        ext = torch.where((role[c] != 0) & (part[c] // COLS != j), part[c],
                          torch.full_like(c, -1))
        e2 = tile(pm[j], ext) if pm[j] >= 0 else None
        v = e1.clone()
        for n in range(COLS):
            rl = int(role[c[n]])
            if rl == 0:
                continue
            p = int(part[c[n]])
            y = e1[:, :, p - j * COLS] if p // COLS == j else e2[:, :, n]
            u, w = (e1[:, :, n], y) if rl == 1 else (y, e1[:, :, n])
            c_, s_ = ca[:, :, 0], sa[:, :, 0]
            tana = s_ / c_
            un = (u + w * tana) / (c_ + s_ * tana)
            v[:, :, n] = un if rl == 1 else (w - un * s_) / c_
        v[:, :, meth[c] < 0] = 0.0
        blocks[:, :, j * COLS:(j + 1) * COLS] = v
        partial[:, j] = (v.double() ** 2).view(
            n_tiles, ok.NSTRIP, -1).sum(dim=2)
    out = blocks.view(nty, ntx, 32, 32, Cp).permute(0, 2, 1, 3, 4).reshape(
        nty * 32, ntx * 32, Cp)
    return out, partial.view(n_tiles, -1).sum(dim=1).view(nty, ntx).float()


@pytest.mark.parametrize("name", ["w8_tail", "straddle", "tail_chunk"])
def test_table_as_the_kernel_reads_it(name):
    n_tiles, W, Cp, ranges, rotate = SHAPES[name]
    nty, ntx = 1, n_tiles
    rng = np.random.default_rng(11)
    As = []
    for _ in ranges:
        A = rng.random((n_tiles, W, TILE)).astype(np.float32)
        A *= rng.random((n_tiles, W, TILE)) < 3.0 / W
        As.append(torch.from_numpy(A))
    slab = torch.from_numpy(
        rng.standard_normal((n_tiles, W, Cp)).astype(np.float32))
    alpha = rng.uniform(-0.5, 0.5, (n_tiles, 32, 32))
    cosa = torch.from_numpy(np.cos(alpha).astype(np.float32))
    sina = torch.from_numpy(np.sin(alpha).astype(np.float32))
    plan = ok.launch_plan(n_tiles, W, Cp, ranges, rotate, "highest")
    got, gcs = _emulate(plan, As, slab, nty, ntx, cosa, sina)
    ref, rcs = ok.onehot_apply_packed_plain(
        As, slab, ranges=ranges, nty=nty, ntx=ntx, precision="highest",
        with_checksum=True, rotate=rotate, cosa=cosa, sina=sina)
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    torch.testing.assert_close(gcs, rcs, rtol=1e-5, atol=0)
    assert (got[:, :, ranges[-1][1]:] == 0).all()
