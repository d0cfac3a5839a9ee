"""One-hot-operator apply: the Hopper kernel, its plain twins, the bf16
split helpers and the kernel's launch plan.

Counterpart of the two TPU kernels of ``mpassit_tpu/ops/pallas_matmul.py``
that take a one-hot operator ``A`` (``matmul_apply._build_A_T``):

``onehot_apply_packed`` stands for both: one ``A`` per method column range
over one union slab, then the Q4 rotation, tail zeros and the optional
per-tile checksum, as ``packed_apply`` (``fused_apply_packed`` with
``As=``); a single method is one range over every column, ``A[t]^T @
slab[t]`` in the row-major ``(nty*32, ntx*32, Cp)`` target layout
(``fused_apply``).

``A`` is ``(n_tiles, W, 1024)`` f32 here. The TPU takes it prestacked into
3 or 6 bf16 copies (``_prep_A``); the CUDA kernel (``csrc/onehot_apply.cu``)
splits both operands into bf16 parts in shared memory and sums the terms
on the tensor cores (``wgmma``, f32 accumulation):

    split_bf16:   Ah Sh + Ah Sl + Al Sh                    (_stack_A/_stack_S)
    split6_bf16:  A0S0 + A0S1 + A1S0 + A0S2 + A1S1 + A2S0  (_stack_A6/_stack_S6)
    highest:      the kernel: the split6_bf16 terms; the plain version: A @ S
                  in f32

with ``hi = bf16_rn(x)``, ``lo = bf16_rn(x - hi)`` and the three-way parts
of ``_split_3way``. The kernel's ``highest`` is the six-term set because the
TPU's is: the JAX package computes it with "f32 operands at
Precision.HIGHEST (XLA's own bf16_6x, six MXU passes)"
(``mpassit_tpu/ops/matmul_apply.py:74-79``), the six terms of split6_bf16.
The dropped A1S2 + A2S1 + A2S2 are about 2^-24 relative, so the kernel's
``highest`` agrees with the plain f32 product within 1e-6 of its largest
magnitude (``tests/test_torch_onehot_plan.py`` pins that on the CPU). A
product of two bf16 values is exact in f32, so otherwise only the order of
the f32 sums differs between the kernel, the plain version and the TPU.
The plain versions (``_tile_matmul`` on the stacked operands, per tile
row, then the shared epilogue of ops/packed_kernel.py) need full f32
matrix products: ``torch.backends.cuda.matmul.allow_tf32`` False, the
default, on a card.

``launch_plan`` is the kernel's launch geometry as a pure function: padded
K, the grid, the method passes of each 128-column chunk, where each
rotation partner is computed, the checksum partials and the dynamic shared
memory. Its ``table`` is what the kernel reads on the device.

The wrapper launches the kernel for CUDA tensors and runs its plain
version for CPU tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import functools
import os
import threading
from dataclasses import dataclass

import torch

from . import _build
from ._build import ints, ptr, ptrs
from .packed_kernel import (
    LANE,
    MAX_METHODS,
    MAX_WINDOWS,
    TILE,
    _check_layout,
    _outputs,
    _plain_rows,
    _route,
    _stream,
)

#: precision -> the number of bf16 product terms the kernel sums
TERMS = {"highest": 6, "split_bf16": 3, "split6_bf16": 6}
# the geometry of csrc/onehot_apply.cu
COLS = LANE         # columns per block (the wgmma N)
PTS = 128           # target points per block (two warpgroups of 64 rows)
NSTRIP = TILE // PTS
KS = 32             # operator rows per pipeline step
K_STEP = 16         # the wgmma depth: K is W padded to a multiple of it
EPAD = 136          # row stride (floats) of a staged f32 tile
SMEM_MAX = 232_448  # dynamic shared memory a block can have on an H100
W_CAP = 2048        # matmul_apply.W_CAP: the widest slab a pack builds

#: kernel launches per wrapper (one per call on a CUDA tensor)
LAUNCHES = {"onehot_apply_packed": 0}
#: calls of each plain version
PLAIN_CALLS = {"onehot_apply_packed": 0}

SOURCE = os.path.join(_build.CSRC, "onehot_apply.cu")
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()
_lib = None
#: what the last build did: {"so", "seconds", "log"}
BUILD_INFO: dict = {}

_P, _I, _IP, _PP = _build.P, _build.I, _build.IP, _build.PP
_ARGTYPES = [_P, _P, _PP, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _P]


def build():
    """Compile ``csrc/onehot_apply.cu`` (once per source content) and load
    it. Returns the ctypes library; raises on a failed build or load."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build.load(SOURCE, BUILD_DIR,
                               {"onehot_apply_launch": _ARGTYPES}, BUILD_INFO)
        return _lib


# ------------------------------------------------------- split helpers ----

def _split_hilo(x):
    """f32 -> (hi, lo) bf16 pair with x ~= hi + lo, each rounded to
    nearest-even (matmul_apply._split_hilo)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def _split_3way(x):
    """f32 -> (b0, b1, b2) bf16 triple with x ~= b0 + b1 + b2
    (matmul_apply._split_3way)."""
    b0 = x.to(torch.bfloat16)
    r1 = x - b0.float()
    b1 = r1.to(torch.bfloat16)
    b2 = (r1 - b1.float()).to(torch.bfloat16)
    return b0, b1, b2


def _stack_A(A, axis):
    """A -> (Ah, Ah, Al) stacked bf16; pairs with _stack_S."""
    hi, lo = _split_hilo(A)
    return torch.cat([hi, hi, lo], dim=axis)


def _stack_S(S, axis):
    """S -> (Sh, Sl, Sh) stacked bf16."""
    hi, lo = _split_hilo(S)
    return torch.cat([hi, lo, hi], dim=axis)


def _stack_A6(A, axis):
    """A -> (A0, A0, A1, A0, A1, A2) stacked bf16; pairs with _stack_S6."""
    a0, a1, a2 = _split_3way(A)
    return torch.cat([a0, a0, a1, a0, a1, a2], dim=axis)


def _stack_S6(S, axis):
    """S -> (S0, S1, S0, S2, S1, S0) stacked bf16."""
    s0, s1, s2 = _split_3way(S)
    return torch.cat([s0, s1, s0, s2, s1, s0], dim=axis)


def _prep_A(A, precision):
    """f32 A -> the operand the TPU kernels stream: stacked bf16 for the
    split modes, f32 for highest (matmul_apply._prep_A)."""
    if precision == "split_bf16":
        return _stack_A(A, 1)
    if precision == "split6_bf16":
        return _stack_A6(A, 1)
    return A.float()


def _tile_matmul(A, slab, precision):
    """Batched per-tile product (n_tiles, TILE, C) of a prepped A
    (``_prep_A``) and an f32 slab, split to match (matmul_apply
    ._tile_matmul); the bf16 values are multiplied and summed in f32."""
    if precision == "split_bf16":
        slab = _stack_S(slab, 1)
    elif precision == "split6_bf16":
        slab = _stack_S6(slab, 1)
    return torch.bmm(A.float().transpose(1, 2), slab.float())


# --------------------------------------------------------- launch plan ----

def _smem_bytes(terms, partner):
    """csrc/onehot_apply.cu::smem_bytes: the double-buffered ring of bf16
    parts (or one staged f32 tile, if larger), plus the own tile's stage
    when a partner tile is computed."""
    parts = 2 if terms == 3 else 3
    ring = 2 * 2 * parts * PTS * KS * 2
    tile = PTS * EPAD * 4
    return max(ring, tile) + (tile if partner else 0)


@dataclass(frozen=True)
class LaunchPlan:
    """The geometry of one launch of csrc/onehot_apply.cu (``launch_plan``)."""

    n_tiles: int
    K: int              # W padded to a multiple of K_STEP
    steps: int          # KS-row pipeline steps per method pass
    grid: int           # blocks: (tile, chunk, strip), strips fastest
    nchunk: int
    terms: int
    own: tuple          # per chunk: the methods of its K passes, in order
    partner: tuple      # per chunk: the partner tile's methods, or None
    #: per chunk: the (column, partner) pairs whose partner lies outside
    #: the chunk; computed at the column's position in the partner tile
    external: tuple
    n_parts: int        # checksum partials per tile
    smem: int           # dynamic shared-memory bytes
    table: tuple        # the int table the kernel reads

    @property
    def partnered(self):
        """Whether some chunk computes a partner tile."""
        return any(p is not None for p in self.partner)

    @property
    def passes(self):
        """K passes of one tile's blocks (own and partner tiles)."""
        return NSTRIP * (sum(map(len, self.own))
                         + sum(len(p) for p in self.partner if p))

    @property
    def flop(self):
        """Tensor-core FLOP of the launch: every term of every pass at
        the padded K."""
        return (2 * self.terms * PTS * COLS * self.K * self.passes
                * self.n_tiles)


def launch_plan(n_tiles, W, Cp, ranges, rotate=(), precision="split6_bf16"):
    """The launch geometry of ``onehot_apply_packed`` on a card, for
    ``n_tiles`` tiles of a (W-row, Cp-column) slab, the method column
    ``ranges`` and the ``(cu, cv, n)`` rotation windows. Raises ValueError
    on what the kernel does not take: W outside [1, W_CAP], Cp not a
    positive multiple of 128, more than MAX_METHODS ranges or MAX_WINDOWS
    windows, ranges that do not tile [0, C <= Cp), windows that leave
    [0, Cp) or share a column, a grid over 2^31 - 1 blocks.

    Every column ``c < ranges[-1][1]`` is computed once, in chunk
    ``c // 128``'s own pass of its method (``table[c]``); the rest are the
    zero tail. A rotated column whose partner lies in another chunk reads
    it from the chunk's partner tile, which stages the partners' slab
    columns under their own methods' passes."""
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    if precision not in TERMS:
        raise ValueError(f"precision must be one of {tuple(TERMS)}")
    if not 1 <= W <= W_CAP:
        raise ValueError(f"W={W} outside [1, {W_CAP}]")
    if Cp < COLS or Cp % COLS:
        raise ValueError(f"column count {Cp} not a positive multiple of "
                         f"{COLS}")
    if n_tiles < 1:
        raise ValueError("no tiles")
    if not 1 <= len(ranges) <= MAX_METHODS or len(rotate) > MAX_WINDOWS:
        raise ValueError(f"1 to {MAX_METHODS} ranges and at most "
                         f"{MAX_WINDOWS} rotate windows per launch")
    method = [-1] * Cp
    prev = 0
    for m, (c0, c1) in enumerate(ranges):
        if c0 != prev or c1 <= c0 or c1 > Cp:
            raise ValueError(f"ranges must tile [0, C <= {Cp}) "
                             f"contiguously: {ranges}")
        method[c0:c1] = [m] * (c1 - c0)
        prev = c1
    role, part = [0] * Cp, [-1] * Cp
    for (cu, cv, n) in rotate:
        if n < 1 or min(cu, cv) < 0 or max(cu, cv) + n > Cp:
            raise ValueError(f"rotate window {(cu, cv, n)} outside "
                             f"[0, {Cp})")
        for i in range(n):
            for c, p, rl in ((cu + i, cv + i, 1), (cv + i, cu + i, 2)):
                if role[c]:
                    raise ValueError(f"rotate windows share column {c}")
                role[c], part[c] = rl, p
    nchunk = Cp // COLS
    grid = n_tiles * nchunk * NSTRIP
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{grid} blocks exceed the grid limit")
    own, partner, external = [], [], []
    for j in range(nchunk):
        cols = range(j * COLS, (j + 1) * COLS)
        own.append(tuple(sorted({method[c] for c in cols if method[c] >= 0})))
        ext = tuple((c, part[c]) for c in cols
                    if role[c] and part[c] // COLS != j)
        external.append(ext)
        partner.append(tuple(sorted({method[p] for _, p in ext
                                     if method[p] >= 0})) if ext else None)
    terms = TERMS[precision]
    masks = [sum(1 << m for m in ms) for ms in own]
    pmasks = [-1 if p is None else sum(1 << m for m in p) for p in partner]
    K = -(-W // K_STEP) * K_STEP
    return LaunchPlan(
        n_tiles=n_tiles, K=K, steps=-(-K // KS), grid=grid, nchunk=nchunk,
        terms=terms,
        own=tuple(own), partner=tuple(partner), external=tuple(external),
        n_parts=nchunk * NSTRIP,
        smem=_smem_bytes(terms, any(p is not None for p in partner)),
        table=tuple(method + role + part + masks + pmasks))


@functools.lru_cache(maxsize=32)
def _plan_on(dev, n_tiles, W, Cp, ranges, rotate, precision):
    """launch_plan and its table on ``dev``, once per geometry: a launch
    enqueues the kernel without building either on the host."""
    plan = launch_plan(n_tiles, W, Cp, ranges, rotate, precision)
    return plan, torch.tensor(plan.table, dtype=torch.int32, device=dev)


# ------------------------------------------------------------ wrappers ----

def _check_onehot(As, slab, precision):
    if precision not in TERMS:
        raise ValueError(f"precision must be one of {tuple(TERMS)}")
    if slab.dim() != 3 or slab.dtype != torch.float32:
        raise ValueError("slab must be a (n_tiles, W, Cp) float32 tensor")
    n_tiles, W, _ = slab.shape
    for A in As:
        if A.shape != (n_tiles, W, TILE) or A.dtype != torch.float32:
            raise ValueError(
                f"A must be (n_tiles, W, 1024) = {(n_tiles, W, TILE)} f32, "
                f"got {tuple(A.shape)} {A.dtype}")


def _launch(As, slab, ranges, nty, ntx, precision, rotate, cosa, sina,
            with_checksum):
    n_tiles, W, Cp = slab.shape
    dev = slab.device
    plan, table = _plan_on(dev, n_tiles, W, Cp, ranges, rotate, precision)
    slab = slab.contiguous()
    As = [A.contiguous() for A in As]
    if rotate:
        cosa, sina = cosa.contiguous(), sina.contiguous()
    lib = build()
    out, partial, checksum = _outputs(dev, n_tiles, nty, ntx, Cp,
                                      plan.n_parts, with_checksum)
    with torch.cuda.device(dev):
        rc = lib.onehot_apply_launch(
            slab.data_ptr(), out.data_ptr(), ptrs(As), len(As),
            table.data_ptr(), int(plan.partnered),
            ptr(cosa if rotate else None), ptr(sina if rotate else None),
            ptr(partial), ptr(checksum), n_tiles, ntx, W, plan.K, Cp,
            plan.terms, plan.smem, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"onehot_apply_launch failed: rc={rc}")
    LAUNCHES["onehot_apply_packed"] += 1
    if with_checksum:
        return out, checksum
    return out


def onehot_apply_packed(As, slab, *, ranges, nty, ntx,
                        precision="split_bf16", with_checksum=False,
                        rotate=(), cosa=None, sina=None):
    """As: one (n_tiles, W, 1024) f32 one-hot operator per method over the
    union slab (n_tiles, W, Cp); ranges, rotate, cosa/sina and the outputs
    as for ops/packed_kernel.packed_apply (the contract of
    pallas_matmul.fused_apply_packed with As=)."""
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    _check_onehot(As, slab, precision)
    n_tiles, _, Cp = slab.shape
    _check_layout(n_tiles, Cp, ranges, nty, ntx, rotate, cosa, sina)
    if len(As) != len(ranges):
        raise ValueError("one A per range is required")
    if not _route("onehot_apply_packed", slab.device, [*As, cosa, sina]):
        return onehot_apply_packed_plain(
            As, slab, ranges=ranges, nty=nty, ntx=ntx, precision=precision,
            with_checksum=with_checksum, rotate=rotate, cosa=cosa, sina=sina)
    return _launch(tuple(As), slab, ranges, nty, ntx, precision, rotate,
                   cosa, sina, with_checksum)


# ------------------------------------------------------ plain versions ----

def _onehot_plain(As, slab, ranges, nty, ntx, precision, rotate, cosa, sina,
                  with_checksum):
    Cp = slab.shape[2]

    def row_block(i):
        t0, t1 = i * ntx, (i + 1) * ntx
        s = slab[t0:t1]
        blk = torch.zeros((ntx, TILE, Cp), dtype=torch.float32,
                          device=slab.device)
        for A, (c0, c1) in zip(As, ranges):
            blk[:, :, c0:c1] = _tile_matmul(_prep_A(A[t0:t1], precision),
                                            s[:, :, c0:c1], precision)
        return blk

    return _plain_rows(row_block, nty=nty, ntx=ntx, Cp=Cp, dev=slab.device,
                       rotate=rotate, cosa=cosa, sina=sina,
                       with_checksum=with_checksum)


def onehot_apply_packed_plain(As, slab, *, ranges, nty, ntx,
                              precision="split_bf16", with_checksum=False,
                              rotate=(), cosa=None, sina=None):
    """``onehot_apply_packed`` in plain PyTorch, on any device: per tile
    row and method the stacked-operand product, then the Q4 rotation,
    tail zeros, checksum and unblock of ops/packed_kernel.py."""
    PLAIN_CALLS["onehot_apply_packed"] += 1
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    _check_onehot(As, slab, precision)
    n_tiles, _, Cp = slab.shape
    _check_layout(n_tiles, Cp, ranges, nty, ntx, rotate, cosa, sina)
    if len(As) != len(ranges):
        raise ValueError("one A per range is required")
    return _onehot_plain(As, slab, ranges, nty, ntx, precision, rotate, cosa,
                         sina, with_checksum)
