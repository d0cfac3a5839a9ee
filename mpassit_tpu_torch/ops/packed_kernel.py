"""Packed multi-method ELL apply: the Hopper kernel and its plain twin.

Counterpart of the ELL-direct branch of
``mpassit_tpu/ops/pallas_matmul.py::fused_apply_packed`` (``As=None`` with
``locs=``/``ws=``), the TPU kernel the default regrid runs. For each
32x32 target tile t, method m with packed column range [c0, c1) and target
point p::

    out[t rows, c0:c1] = sum_k ws_m[t,k,p] * slab[t, locs_m[t,k,p], c0:c1]

written straight into the row-major ``(nty*32, ntx*32, Cp)`` target
layout, then the optional Q4 wind rotation on ``(cu, cv, n)`` column
windows, zeros on the columns ``[ranges[-1][1], Cp)`` and, with
``with_checksum``, per-tile ``sum(out**2)``.

``packed_apply`` launches the CUDA kernel (``csrc/packed_apply.cu``) for
tensors on a CUDA device and runs ``packed_apply_plain`` for tensors on the
CPU; any other device raises. There is no fallback from one to the other.
The kernel is built with ``nvcc`` on first use into ``_build/`` next to
this package and loaded with ctypes; a failed build or launch raises.

The TPU kernel's ``precision`` argument has no counterpart: the sum is
f32 multiplies and adds, which meets the tightest bound the JAX package
documents for its apply (register R10, ~2e-7 max rel err).

``ell_plan`` is the launch geometry of this kernel and of
``ops/gather_kernel.py``'s (one CUDA template, ``csrc/ell_apply.cuh``) as a
pure function, testable on the CPU: per column its method, role (plain,
u, v or tail) and rotation partner, the table the kernel reads; per
block its tile and column range; per launch the block width and whether
the slab rows of a block's columns are staged in shared memory.

The argument checks, the output allocation and the plain epilogue
(rotation, checksum, unblock) here are shared by the other apply kernels
(ops/onehot_kernel.py, ops/gather_kernel.py).
"""

from __future__ import annotations

import functools
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from ._build import ints, ptr, ptrs

TY = 32
TX = 32
TILE = TY * TX
LANE = 128          # column quantum (matches matmul_apply.LANE)
CB = 256            # the TPU kernel's sub-chunk; bounds rotate windows
MAX_METHODS = 8     # MAXM in csrc/ell_apply.cuh
MAX_WINDOWS = 8     # rotate windows per launch of the one-hot kernel
#: column roles of the ell_plan table (ROLE_* in csrc/ell_apply.cuh)
PLAIN, U, V, TAIL = 0, 1, 2, 3
#: block widths in columns with staged rows, widest first (a thread owns 4
#: columns of a 256-thread block, so the kernel takes 64, 128, 256 or 512).
#: 128 measured faster than 256 and 64 at the CONUS pack
#: (tools/ell_probe.py): the rotation window's columns, 4-5 times the work
#: of the others, then spread over more and shorter blocks
BLOCK_COLS = (128,)
#: block width with rows read from device memory: 64 measured faster than
#: 128 at the EDGE1 restagger (more blocks, two points per warp in flight)
UNSTAGED_COLS = 64
#: the most shared memory a block's staged rows may take: two such blocks
#: fit on one SM of an H100
STAGE_MAX = 96 * 1024
#: shared memory of one H100 SM, what the card reserves per block, and
#: the kernel's static shared memory (the checksum's reduction array)
SMEM_SM = 228 * 1024
SMEM_RESERVED = 1024
NT_SMEM = 256 * 4

#: kernel launches by ``packed_apply`` (one per call on a CUDA tensor)
LAUNCHES = 0
#: calls of ``packed_apply_plain``
PLAIN_CALLS = 0

SOURCE = os.path.join(_build.CSRC, "packed_apply.cu")
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()
_lib = None
#: what the last build did: {"so", "seconds", "log"}; seconds is None
#: when an already-built library was loaded
BUILD_INFO: dict = {}

_P, _I, _IP, _PP = _build.P, _build.I, _build.IP, _build.PP
_ARGTYPES = [_P, _P, _PP, _PP, _IP, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I,
             _I, _I, _I, _I, _P]


def build():
    """Compile ``csrc/packed_apply.cu`` (once per source content) and load
    it. Returns the ctypes library; raises on a failed build or load."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build.load(SOURCE, BUILD_DIR,
                               {"packed_apply_launch": _ARGTYPES}, BUILD_INFO)
        return _lib


@dataclass(frozen=True)
class EllPlan:
    """The geometry of one launch of csrc/ell_apply.cuh (``ell_plan``)."""

    n_tiles: int
    W: int              # slab rows of a tile (W8 for the gather kernel)
    Cp: int
    BW: int             # columns per block
    stage: bool         # the block's slab rows staged in shared memory
    smem: int           # dynamic shared-memory bytes (0 without staging)
    #: staged blocks one SM holds, 2 or 3, which the kernel's register
    #: budget allows too (0 without staging): the launch's ``stage``
    min_blocks: int
    nblk: int           # blocks per tile
    cend: int           # first tail column
    method: tuple       # per column: its method, -1 in the tail
    role: tuple         # per column: PLAIN, U, V or TAIL
    partner: tuple      # per column: the window partner, -1 for none
    table: tuple        # per column: the int entry the kernel reads

    @property
    def grid(self):
        return self.n_tiles * self.nblk

    def block(self, b):
        """(tile, first column, end column) of block ``b``: the column
        blocks of a tile are consecutive."""
        t, j = divmod(b, self.nblk)
        return t, j * self.BW, min((j + 1) * self.BW, self.Cp)

    def partner_in_block(self, c):
        """Whether column ``c``'s partner lies in ``c``'s own block (and so
        among its staged rows); otherwise the kernel reads it from device
        memory."""
        p = self.partner[c]
        return p >= 0 and p // self.BW == c // self.BW

    def path(self, c0):
        """The kernel's path for the thread owning columns [c0, c0 + 4):
        "float4" (one method, or the tail, in all four, none rotated),
        "window" (one method, window columns among them, every partner of
        that method) or "scalar" (a method edge: each column alone)."""
        cols = range(c0, c0 + 4)
        m = self.method[c0]
        if any(self.method[c] != m or (self.role[c] in (U, V) and
                                       self.method[self.partner[c]] != m)
               for c in cols):
            return "scalar"
        return ("window" if any(self.role[c] in (U, V) for c in cols)
                else "float4")


def _geometry(W, Cp):
    """(BW, stage): the widest block whose staged rows fit STAGE_MAX, else
    UNSTAGED_COLS columns, unstaged."""
    for bw in BLOCK_COLS:
        if bw <= Cp and W * bw * 4 <= STAGE_MAX:
            return bw, True
    return UNSTAGED_COLS, False


def ell_plan(n_tiles, W, Cp, ranges, rotate=()):
    """The launch geometry of ``packed_apply``/``packed_gather_apply`` on
    a card, for ``n_tiles`` tiles of W slab rows, Cp columns, the method
    column ``ranges`` and the ``(cu, cv, n)`` rotation windows. Raises
    ValueError on what the kernel does not take: W < 1, Cp not a positive
    multiple of 128, more than MAX_METHODS ranges, ranges that do not tile
    [0, C <= Cp), windows that leave the methods' columns or share a
    column, a grid over 2^31 - 1 blocks.

    A rotated column computes its own sum and its partner's; where the
    partner lies outside the column's block (``partner_in_block``), the
    kernel reads the partner's rows from device memory, not from the
    block's staged copy."""
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    if W < 1 or n_tiles < 1:
        raise ValueError(f"W={W}, n_tiles={n_tiles}: both must be >= 1")
    if Cp < LANE or Cp % LANE:
        raise ValueError(f"column count {Cp} not a positive multiple of "
                         f"{LANE}")
    if not 1 <= len(ranges) <= MAX_METHODS:
        raise ValueError(f"1 to {MAX_METHODS} ranges per launch")
    method = [-1] * Cp
    prev = 0
    for m, (c0, c1) in enumerate(ranges):
        if c0 != prev or c1 <= c0 or c1 > Cp:
            raise ValueError(f"ranges must tile [0, C <= {Cp}) "
                             f"contiguously: {ranges}")
        method[c0:c1] = [m] * (c1 - c0)
        prev = c1
    cend = prev
    role = [PLAIN] * cend + [TAIL] * (Cp - cend)
    part = [-1] * Cp
    for (cu, cv, n) in rotate:
        if n < 1 or min(cu, cv) < 0 or max(cu, cv) + n > cend:
            raise ValueError(f"rotate window {(cu, cv, n)} outside the "
                             f"methods' columns [0, {cend})")
        for i in range(n):
            for c, p, rl in ((cu + i, cv + i, U), (cv + i, cu + i, V)):
                if role[c] != PLAIN:
                    raise ValueError(f"rotate windows share column {c}")
                role[c], part[c] = rl, p
    BW, stage = _geometry(W, Cp)
    nblk = -(-Cp // BW)
    if n_tiles * nblk > 2 ** 31 - 1:
        raise ValueError(f"{n_tiles * nblk} blocks exceed the grid limit")
    table = tuple(
        (method[c] + 1) | (role[c] << 4)
        | ((method[part[c]] + 1 if part[c] >= 0 else 0) << 6)
        | (max(part[c], 0) << 10) for c in range(Cp))
    smem = W * BW * 4 if stage else 0
    min_blocks = (min(3, SMEM_SM // (smem + SMEM_RESERVED + NT_SMEM))
                  if stage else 0)
    return EllPlan(n_tiles=n_tiles, W=W, Cp=Cp, BW=BW, stage=stage,
                   smem=smem, min_blocks=min_blocks, nblk=nblk, cend=cend,
                   method=tuple(method), role=tuple(role),
                   partner=tuple(part), table=table)


@functools.lru_cache(maxsize=32)
def _plan_on(dev, n_tiles, W, Cp, ranges, rotate, knobs):
    """ell_plan and its table on ``dev``, once per geometry (and per
    BLOCK_COLS, UNSTAGED_COLS and STAGE_MAX, which a probe may change): a
    launch enqueues
    the kernel without building either on the host."""
    plan = ell_plan(n_tiles, W, Cp, ranges, rotate)
    return plan, torch.tensor(np.asarray(plan.table, np.int32), device=dev)


def plan_on(dev, n_tiles, W, Cp, ranges, rotate):
    return _plan_on(dev, n_tiles, W, Cp, ranges, rotate,
                    (BLOCK_COLS, UNSTAGED_COLS, STAGE_MAX))


def _aligned(ts):
    """The tensors, each contiguous and 16-byte aligned (the kernel's
    loc/w, row and output accesses are 16 bytes wide)."""
    out = []
    for a in ts:
        a = a.contiguous()
        out.append(a if a.data_ptr() % 16 == 0 else a.clone())
    return out


def _validate_rotate(rotate, ranges, Cp):
    """Each (cu, cv, n) window must sit inside ONE CB sub-chunk of one
    method's range. The CUDA kernels have no such limit; the check is kept
    as the JAX package has it (pallas_matmul.py::_validate_rotate) so both
    packages take the same in-kernel versus post-hoc rotation branch."""
    for (cu, cv, n) in rotate:
        ok = False
        for c0, c1 in ranges:
            for lo_c in range(c0, c1, CB):
                cw = min(CB, c1 - lo_c)
                if lo_c <= cu and cu + n <= cv and cv + n <= lo_c + cw:
                    ok = True
        if not ok:
            raise ValueError(
                f"rotate window {(cu, cv, n)} does not fit one CB={CB} "
                f"sub-chunk of ranges {ranges}")


def _check_layout(n_tiles, Cp, ranges, nty, ntx, rotate, cosa, sina):
    """Checks every packed apply shares: grid, column ranges, rotation."""
    if n_tiles != nty * ntx:
        raise ValueError(f"slab has {n_tiles} tiles, grid wants {nty * ntx}")
    if Cp % LANE:
        raise ValueError(f"column count {Cp} not a multiple of {LANE}")
    prev = 0
    for c0, c1 in ranges:
        if c0 != prev or c1 <= c0:
            raise ValueError(f"ranges must tile [0, C) contiguously: {ranges}")
        prev = c1
    if prev > Cp:
        raise ValueError(f"ranges end {prev} exceeds padded width {Cp}")
    if rotate:
        _validate_rotate(rotate, ranges, Cp)
        if cosa is None or sina is None:
            raise ValueError("rotate windows require cosa and sina")
        for a in (cosa, sina):
            if a.shape != (n_tiles, TY, TX) or a.dtype != torch.float32:
                raise ValueError(
                    "cosa/sina must be tile-blocked (n_tiles, 32, 32) f32")


def _check_ell(locs, ws, n_tiles, nm):
    if len(locs) != nm or len(ws) != nm:
        raise ValueError("one locs/ws pair per range is required")
    for loc, w in zip(locs, ws):
        if (loc.dim() != 3 or loc.shape[0] != n_tiles
                or loc.shape[2] != TILE or loc.dtype != torch.int32):
            raise ValueError("locs must be (n_tiles, K, 1024) int32")
        if w.shape != loc.shape or w.dtype != torch.float32:
            raise ValueError("ws must match locs in shape, float32")


def _check_args(slab, locs, ws, ranges, nty, ntx, rotate, cosa, sina):
    if slab.dim() != 3 or slab.dtype != torch.float32:
        raise ValueError("slab must be a (n_tiles, W, Cp) float32 tensor")
    n_tiles, W, Cp = slab.shape
    _check_layout(n_tiles, Cp, ranges, nty, ntx, rotate, cosa, sina)
    _check_ell(locs, ws, n_tiles, len(ranges))


def _route(name, dev, operands):
    """True for a CUDA launch, False for the plain version on the CPU;
    raises for any other device or for operands on another device."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for a in operands:
        if a is not None and a.device != dev:
            raise ValueError(f"operand on {a.device}, {name} input on {dev}")
    return True


def _outputs(dev, n_tiles, nty, ntx, Cp, n_parts, with_checksum):
    """The kernel's output, and with a checksum its per-block partials
    (n_tiles, n_parts) and the (nty, ntx) result."""
    out = torch.empty((nty * TY, ntx * TX, Cp), dtype=torch.float32,
                      device=dev)
    if not with_checksum:
        return out, None, None
    return (out,
            torch.empty((n_tiles, n_parts), dtype=torch.float32, device=dev),
            torch.empty((nty, ntx), dtype=torch.float32, device=dev))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def packed_apply(slab, locs, ws, *, ranges, nty, ntx, rotate=(), cosa=None,
                 sina=None, with_checksum=False):
    """slab (n_tiles, W, Cp) f32; locs/ws: one (n_tiles, K_m, 1024)
    int32/f32 pair per method; ranges: per-method absolute output column
    ranges tiling [0, C) with C <= Cp, Cp % 128 == 0; rotate: (cu, cv, n)
    windows with cosa/sina tile-blocked (n_tiles, 32, 32) f32, padded with
    the identity rotation outside the data.

    Returns (nty*32, ntx*32, Cp) f32 in row-major target layout, and with
    ``with_checksum`` also the (nty, ntx) per-tile sums of out**2."""
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    _check_args(slab, locs, ws, ranges, nty, ntx, rotate, cosa, sina)
    dev = slab.device
    if not _route("packed_apply", dev, [*locs, *ws, cosa, sina]):
        return packed_apply_plain(
            slab, locs, ws, ranges=ranges, nty=nty, ntx=ntx, rotate=rotate,
            cosa=cosa, sina=sina, with_checksum=with_checksum)
    slab, *locs = _aligned([slab, *locs])
    ws = _aligned(ws)
    if rotate:
        cosa, sina = _aligned([cosa, sina])
    n_tiles, W, Cp = slab.shape
    plan, table = plan_on(dev, n_tiles, W, Cp, ranges, rotate)
    lib = build()
    out, partial, checksum = _outputs(dev, n_tiles, nty, ntx, Cp, plan.nblk,
                                      with_checksum)
    with torch.cuda.device(dev):
        rc = lib.packed_apply_launch(
            slab.data_ptr(), out.data_ptr(), ptrs(locs), ptrs(ws),
            ints([a.shape[1] for a in locs]), len(ranges), table.data_ptr(),
            len(rotate), ptr(cosa if rotate else None),
            ptr(sina if rotate else None), ptr(partial), ptr(checksum),
            n_tiles, ntx, W, Cp, plan.cend, plan.BW, plan.min_blocks,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"packed_apply_launch failed: rc={rc}")
    global LAUNCHES
    LAUNCHES += 1
    if with_checksum:
        return out, checksum
    return out


def _rotate_q4(blk, cosa_t, sina_t, rotate):
    """The Q4 rotation of the (cu, cv, n) windows of a (ntx, TILE, Cp)
    tile-row block, in place; cosa_t/sina_t are the row's (ntx, 32, 32)."""
    ntx = blk.shape[0]
    ca = cosa_t.reshape(ntx, TILE, 1)
    sa = sina_t.reshape(ntx, TILE, 1)
    for (cu, cv, n) in rotate:
        u = blk[:, :, cu:cu + n]
        v = blk[:, :, cv:cv + n]
        # quirk Q4: u first, then v from the ROTATED u
        tana = sa / ca
        u_new = (u + v * tana) / (ca + sa * tana)
        v_new = (v - u_new * sa) / ca
        blk[:, :, cu:cu + n] = u_new
        blk[:, :, cv:cv + n] = v_new


def _plain_rows(row_block, *, nty, ntx, Cp, dev, rotate=(), cosa=None,
                sina=None, with_checksum=False):
    """The plain versions' common loop: for each tile row i,
    ``row_block(i)`` gives the (ntx, TILE, Cp) product block (tail columns
    zero); then the Q4 rotation, the checksum and the unblock into the
    row-major output. Memory beyond the output is one tile row's block."""
    out = torch.empty((nty * TY, ntx * TX, Cp), dtype=torch.float32,
                      device=dev)
    checksum = torch.empty((nty, ntx), dtype=torch.float64, device=dev)
    for i in range(nty):
        t0, t1 = i * ntx, (i + 1) * ntx
        blk = row_block(i)
        if rotate:
            _rotate_q4(blk, cosa[t0:t1], sina[t0:t1], rotate)
        if with_checksum:
            checksum[i] = (blk.double() ** 2).sum(dim=(1, 2))
        out[i * TY:(i + 1) * TY] = blk.view(ntx, TY, TX, Cp).permute(
            1, 0, 2, 3).reshape(TY, ntx * TX, Cp)
    if with_checksum:
        return out, checksum.float()
    return out


def _ell_row(rows, locs, ws, ranges, t0, t1, Cp):
    """(ntx, TILE, Cp) block of tiles [t0, t1): per method the K-term
    gather-sum over ``rows`` (ntx, W, Cp), the rows of those tiles."""
    ntx = t1 - t0
    blk = torch.zeros((ntx, TILE, Cp), dtype=torch.float32,
                      device=rows.device)
    tix = torch.arange(ntx, device=rows.device)[:, None]
    for (c0, c1), loc, w in zip(ranges, locs, ws):
        sc = rows[:, :, c0:c1]
        acc = None
        for k in range(loc.shape[1]):
            g = sc[tix, loc[t0:t1, k, :].long()]            # (ntx, TILE, cw)
            term = w[t0:t1, k, :, None] * g
            acc = term if acc is None else acc + term
        blk[:, :, c0:c1] = acc
    return blk


def packed_apply_plain(slab, locs, ws, *, ranges, nty, ntx, rotate=(),
                       cosa=None, sina=None, with_checksum=False):
    """The same function as ``packed_apply`` in plain PyTorch, on any
    device: per tile row, an index gather and K-term sum per method, the
    Q4 rotation, the unblock into row-major order, tail zeros and the
    checksum. Memory beyond the output is one tile row's (ntx*1024, Cp)
    block at a time."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    _check_args(slab, locs, ws, ranges, nty, ntx, rotate, cosa, sina)
    Cp = slab.shape[2]

    def row_block(i):
        t0, t1 = i * ntx, (i + 1) * ntx
        return _ell_row(slab[t0:t1], locs, ws, ranges, t0, t1, Cp)

    return _plain_rows(row_block, nty=nty, ntx=ntx, Cp=Cp, dev=slab.device,
                       rotate=rotate, cosa=cosa, sina=sina,
                       with_checksum=with_checksum)
