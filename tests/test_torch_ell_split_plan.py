"""The ELL-built one-hot kernels' launch plan and numerics on the CPU.

- ``ell_split_plan``, the launch geometry of csrc/ell_split_apply.cu: padded
  K, steps, columns per block (64 points each), grid and dynamic shared memory
  at the smoke shape (bilinear operator, W = 40, K = 3, Cp = 512), at the
  kernel-variants tool's W = 80 and at the edges (W = 1, W = V2_MAX_W,
  K = 16, Cp = 128 and 1024); its ValueErrors, V2_MAX_W among them.
- The kernel's A build emulated in numpy (``_emulate_build``: each thread's
  pieces zeroed, then per point the sum of each distinct row's weights in
  k order, split once and scattered as bf16 into the k16-chunk layout of
  ``chunk_off``), read back through the wgmma operand descriptors (LBO,
  SBO, each warpgroup's M tile): bit for bit ``_split_hilo(_one_hot(...))``
  with duplicates, pads, rows >= W and negative locs.
- The kernel's sum emulated step by step on those parts (per k16 chunk,
  Ah Sh into one f32 accumulator, Ah Sl + Al Sh into the other, added once
  at the end) against ``ell_split_apply_v1_plain``: f32 sums in another
  order, so within 1e-6 of max|plain|, on slab values spread over
  2^-20..2^20.
"""

import numpy as np
import pytest
import torch

from mpassit_tpu_torch.ops import variant_kernels as vk
from mpassit_tpu_torch.ops.onehot_kernel import _split_hilo

TILE = 1024
SMOKE = (1938, 40, 512, 3)        # the smoke run's bilinear operator
TOOL = (1938, 80, 512, 3)         # the tool's 2.6M-cell problem
VARIANTS = [("v1", 128), ("v2", 128), ("v2", 256)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _chunk_off(r, k):
    """csrc/ell_split_apply.cu::chunk_off."""
    return ((r >> 3) * 2 + ((k >> 3) & 1)) * 128 + (r & 7) * 16 + (k & 7) * 2


# --------------------------------------------------------- launch plan ----

SHAPES = {
    "smoke": SMOKE, "tool_w80": TOOL, "w1": (6, 1, 512, 3),
    "w_max": (6, vk.V2_MAX_W, 512, 3), "k16": (6, 40, 512, 16),
    "cp128": (6, 40, 128, 3), "cp1024": (6, 40, 1024, 3),
    "w_max_k16_cp1024": (2, vk.V2_MAX_W, 1024, 16),
}


@pytest.mark.parametrize("variant,CC", VARIANTS)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_geometry(name, variant, CC):
    n_tiles, W, Cp, K = SHAPES[name]
    if Cp % CC:
        with pytest.raises(ValueError, match="multiple of"):
            vk.ell_split_plan(n_tiles, W, Cp, K, variant, CC)
        return
    plan = vk.ell_split_plan(n_tiles, W, Cp, K, variant, CC)
    assert plan.Kpad % 16 == 0 and W <= plan.Kpad < W + 16
    assert plan.steps == -(-plan.Kpad // 32)
    assert plan.cols == CC                  # one 64 x 128 wgmma tile a warpgroup
    per_tile = TILE // 64 * (Cp // 128 if variant == "v1" else 1)
    assert plan.grid == n_tiles * per_tile
    assert 0 < plan.smem <= vk.SMEM_MAX
    # the shared memory from first principles: one k16 chunk of one bf16
    # part is 64 points (or cols columns) x 16 x 2 bytes; three 32-row f32
    # slab stages; the staged tile has 8 floats of padding a row; loc/w 8
    # bytes an entry
    stages = 3 * 32 * CC * 4
    tile = 64 * (CC + 8) * 4
    locw = K * 64 * 8
    if variant == "v1":
        ring = 2 * (2 * 2 * 64 * 32 + 2 * 2 * CC * 32)
        assert plan.smem == max(ring, tile) + stages + locw
    else:
        a = 2 * plan.Kpad * 64 * 2
        assert plan.smem == a + stages + max(2 * 2 * 2 * CC * 32, tile, locw)
    assert plan.flop == 3 * 2 * n_tiles * TILE * plan.Kpad * Cp


def test_plan_numbers_at_the_smoke_shape():
    v1, v2, v2w = (vk.ell_split_plan(*SMOKE, v, cc) for v, cc in VARIANTS)
    assert (v1.Kpad, v1.steps) == (48, 2)
    assert (v1.grid, v2.grid, v2w.grid) == (1938 * 4 * 16, 1938 * 16,
                                             1938 * 16)
    assert (v1.smem, v2.smem, v2w.smem) == (99_840, 96_256, 178_176)
    assert v1.flop == 3 * 2 * 1938 * 1024 * 48 * 512     # 2.9e11
    tool = vk.ell_split_plan(*TOOL, "v2", 128)
    assert (tool.Kpad, tool.steps, tool.smem) == (80, 3, 104_448)


def test_v2_max_w_is_the_widest_slab_that_fits():
    assert vk.V2_MAX_W == 256 and vk.V2_MAX_W >= 80
    for CC in vk.V2_CC:
        plan = vk.ell_split_plan(1, vk.V2_MAX_W, 512, vk.MAX_K, "v2", CC)
        assert plan.smem <= vk.SMEM_MAX
    # 16 rows more no longer fit at CC = 256, the tighter of the two
    assert vk._smem("v2", 256, vk.MAX_K, vk.V2_MAX_W + 16) > vk.SMEM_MAX
    for CC in vk.V2_CC:
        with pytest.raises(ValueError, match="shared memory"):
            vk.ell_split_plan(1, vk.V2_MAX_W + 1, 512, 3, "v2", CC)
    # v1 streams A by windows: any width
    assert vk.ell_split_plan(1, 2048, 512, 3, "v1").Kpad == 2048


@pytest.mark.parametrize("args,match", [
    ((1, 40, 512, 0, "v1"), "K = 0"),
    ((1, 40, 512, 17, "v1"), "K = 17"),
    ((1, 0, 512, 3, "v1"), "W=0"),
    ((0, 40, 512, 3, "v1"), "n_tiles=0"),
    ((1, 40, 100, 3, "v1"), "multiple of 128"),
    ((1, 40, 384, 3, "v2", 256), "multiple of 256"),
    ((1, 40, 512, 3, "v1", 256), "no v1 kernel"),
    ((1, 40, 512, 3, "v2", 64), "no v2 kernel"),
    ((1, 40, 512, 3, "v3"), "no v3 kernel"),
    ((2 ** 24, 40, 2048, 3, "v1"), "grid limit"),
])
def test_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        vk.ell_split_plan(*args)


# ------------------------------------------------ the A build, emulated ----

def _problem(seed, n_tiles, W, K, Cp=128):
    """loc/w with duplicate locs, points whose K locs all name one row,
    w = 0 pads at loc 0, rows >= W and negative locs; a slab spread over
    2^-20..2^20."""
    rng = np.random.default_rng(seed)
    loc = rng.integers(0, W, (n_tiles, K, TILE)).astype(np.int32)
    w = rng.random((n_tiles, K, TILE)).astype(np.float32)
    if K > 1:
        loc[:, -1, : TILE // 3] = loc[:, 0, : TILE // 3]      # duplicates
        loc[:, :, ::5] = loc[:, :1, ::5]                       # one row
    pad = rng.random((n_tiles, K, TILE)) < 0.2
    loc[pad], w[pad] = 0, 0.0
    loc[:, 0, ::7] = W + rng.integers(0, 40, TILE)[::7]        # rows >= W
    loc[:, K - 1, 3::11] = -rng.integers(1, 40, TILE)[3::11]   # negative
    mag = 2.0 ** rng.uniform(-20, 20, (n_tiles, W, Cp))
    slab = (rng.standard_normal((n_tiles, W, Cp)) * mag).astype(np.float32)
    return loc, w, slab


def _emulate_build(loc, w, W, threads, klo, khi, p0, pts=64):
    """csrc/ell_split_apply.cu::build_a for one block of ``threads``
    threads (points p0 .. p0 + pts - 1) and the rows [klo, khi): a
    (2, nchunk * pts * 16) uint16 buffer (Ah, Al parts) as the block's
    threads leave it. Each thread (point p, piece q) zeroes and fills only
    its own pieces."""
    K = loc.shape[0]
    tpp = threads // pts
    piece = 32 // tpp
    nchunk = (khi - klo) // 16
    buf = np.full((2, nchunk * pts * 16), 0xFFFF, np.uint16)   # NaN garbage
    lp, wp = loc[:, p0:p0 + pts], w[:, p0:p0 + pts]
    p = np.arange(pts)
    for q in range(tpp):
        for r0 in range(klo + q * piece, khi, 32):
            for g in range(0, piece, 8):
                r = r0 + g - klo
                off = (r >> 4) * pts * 32 + _chunk_off(p, r & 15)
                for i in range(8):
                    buf[:, (off + 2 * i) // 2] = 0
    for k in range(K):
        lk = lp[k]
        own = ((lk >= klo) & (lk < khi) & (lk < W))
        own &= ~np.any(lp[:k] == lk, axis=0)           # first occurrence
        s = np.zeros(pts, np.float32)
        for j in range(k, K):
            s = np.where(lp[j] == lk, s + wp[j], s).astype(np.float32)
        hi, lo = _split_hilo(torch.from_numpy(s))
        r = np.where(own, lk - klo, 0)
        off = ((r >> 4) * pts * 32 + _chunk_off(p, r & 15)) // 2
        buf[0, off[own]] = hi.view(torch.int16).numpy().view(np.uint16)[own]
        buf[1, off[own]] = lo.view(torch.int16).numpy().view(np.uint16)[own]
    return buf


def _read_operand(buf, pts, nchunk):
    """A (2, Kpad, pts) bf16 bits as the wgmma reads it: for each k16 chunk
    and each warpgroup's 64-point M tile, element (m, k) at start +
    (m // 8) SBO + (k // 8) LBO + (m % 8) 16 + (k % 8) 2."""
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    out = np.empty((2, nchunk * 16, pts), np.uint16)
    for j in range(nchunk):
        for tile0 in range(0, pts, 64):
            start = j * pts * 32 + (tile0 // 8) * vk.SBO
            addr = (start + (m // 8) * vk.SBO + (k // 8) * vk.LBO
                    + (m % 8) * 16 + (k % 8) * 2)
            out[:, j * 16 + k, tile0 + m] = buf[:, addr // 2]
    return out


def _emulated_parts(loc, w, W, variant, CC):
    """The (2, n_tiles, Kpad, 1024) f32 parts (Ah, Al) every block of the
    variant builds and its wgmma read back: v1 per 32-row window, v2 all
    rows at once."""
    n_tiles, K, _ = loc.shape
    plan = vk.ell_split_plan(n_tiles, W, CC, K, variant, CC)
    parts = np.empty((2, n_tiles, plan.Kpad, TILE), np.uint16)
    wins = ([(k0, min(k0 + 32, plan.Kpad)) for k0 in range(0, plan.Kpad, 32)]
            if variant == "v1" else [(0, plan.Kpad)])
    for t in range(n_tiles):
        for p0 in range(0, TILE, vk.PTS):
            for klo, khi in wins:
                buf = _emulate_build(loc[t], w[t], W, plan.cols, klo, khi,
                                     p0)
                parts[:, t, klo:khi, p0:p0 + vk.PTS] = _read_operand(
                    buf, vk.PTS, (khi - klo) // 16)
    bits = torch.from_numpy(parts.astype(np.int32) << 16)
    return bits.view(torch.float32), plan


@pytest.mark.parametrize("variant,CC", VARIANTS)
@pytest.mark.parametrize("W,K", [(1, 1), (15, 16), (40, 3), (80, 4)])
def test_emulated_build_is_the_split_one_hot(W, K, variant, CC):
    loc, w, _ = _problem(W + K, 2, W, K)
    parts, plan = _emulated_parts(loc, w, W, variant, CC)
    A = vk._one_hot(torch.from_numpy(loc), torch.from_numpy(w), W)
    ref = torch.zeros((2, 2, plan.Kpad, TILE))
    for i, x in enumerate(_split_hilo(A)):
        ref[i, :, :W] = x.float()
    assert parts.numpy().tobytes() == ref.numpy().tobytes()


@pytest.mark.parametrize("W,K,Cp", [(40, 3, 256), (80, 16, 128),
                                    (15, 4, 384)])
def test_emulated_sum_matches_the_plain_version(W, K, Cp):
    nty, ntx = 1, 2
    loc, w, slab = _problem(W * K, nty * ntx, W, K, Cp)
    (ah, al), plan = _emulated_parts(loc, w, W, "v1", 128)
    S = torch.zeros((nty * ntx, plan.Kpad, Cp))
    S[:, :W] = torch.from_numpy(slab)
    sh, sl = (x.float() for x in _split_hilo(S))
    big = torch.zeros((nty * ntx, TILE, Cp))
    small = torch.zeros_like(big)
    for j in range(plan.Kpad // 16):               # the k16 chunks in order
        ks = slice(16 * j, 16 * j + 16)
        aht, alt = ah[:, ks].transpose(1, 2), al[:, ks].transpose(1, 2)
        big += torch.bmm(aht, sh[:, ks])
        small += torch.bmm(aht, sl[:, ks])
        small += torch.bmm(alt, sh[:, ks])
    got = (big + small).view(nty, ntx, 32, 32, Cp).permute(
        0, 2, 1, 3, 4).reshape(nty * 32, ntx * 32, Cp)
    ref = vk.ell_split_apply_v1_plain(*(torch.from_numpy(a) for a in
                                        (loc, w, slab)), nty=nty, ntx=ntx)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-6 * scale
    assert torch.isfinite(got).all()
